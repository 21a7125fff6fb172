"""The port's spans and counters (`utils/profiling.py`) on the CPU.

Off by default: a fit step and a render record no `cbtr.*` profiler event
and no span time, and the autograd graph holds no boundary Function.  On:
every span the CPU path reaches shows in a fit step's profile, each
backward span inside `cbtr.step.backward`; span timing adds up on nested
spans and on other threads; the K1 and K2 twins count the pairs they
evaluate; and images, losses and gradients are bit-equal with every
switch on and with all off.  The launch spans and the kernels' own
counters run only on the card (chip_smoke phase q holds the counters
there).
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time

import pytest
import torch

from cbtr_tpu_torch.models import lens_model, scenes
from cbtr_tpu_torch.ops import cuda_recompute as cr
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import cuda_winner as cw
from cbtr_tpu_torch.render import render
from cbtr_tpu_torch.utils import profiling

torch.set_num_threads(2)
RES = 12

# the spans a CPU fit step reaches (the launch spans and the kernels'
# backward spans are the card's; `cbtr.backward.recompute` is reached on
# the kernel route, `kernel_route`)
FIT_SPANS = {"cbtr.step", "cbtr.step.forward", "cbtr.step.backward", "cbtr.step.update",
             "cbtr.render", "cbtr.tables", "cbtr.refract", "cbtr.winner_search",
             "cbtr.recompute", "cbtr.screen_hits", "cbtr.splat", "cbtr.backward.splat",
             "cbtr.backward.screen_hits", "cbtr.backward.refract",
             "cbtr.backward.gather_rows"}
BOUNDARY_NODES = ("_GradOutBackward", "_GradInBackward")


@pytest.fixture(scope="module")
def scene():
    return scenes.sphere_lens_scene(res=RES, sectors=9, belts=4, device="cpu")


@pytest.fixture
def kernel_route(monkeypatch):
    """The recompute on `_Recompute` with CPU tensors: its launchers the
    plain versions, its route taken as for CUDA tensors."""
    monkeypatch.setattr(cr, "launch_forward", cr.recompute_forward_reference)
    monkeypatch.setattr(cr, "launch_backward", cr.recompute_adjoint_reference)
    monkeypatch.setattr(cr, "on_kernels", lambda table, backend="auto": backend == "auto")


def _target():
    return torch.linspace(0.0, 1.0, RES * RES).reshape(RES, RES)


def _fit_step(scene, optimizer="adam", chunk_size=0):
    """One step from the scene's lens: (loss, image, grads, new parameters)."""
    params = lens_model.params_from_scene(scene)
    images = []
    render_image = lens_model.render_lens_image

    def kept(*args, **kwargs):
        img = render_image(*args, **kwargs)
        images.append(img.detach().clone())
        return img

    lens_model.render_lens_image = kept
    try:
        if optimizer == "adam":
            opt = torch.optim.Adam([params.control_points, params.refractive_index], lr=1e-3)
            step = lens_model.make_opt_train_step(scene.screen_plane, _target(),
                                                  resolution=RES, chunk_size=chunk_size)
            _, _, loss = step(params, opt, scene.start, scene.direction)
        else:
            step = lens_model.make_train_step(scene.screen_plane, _target(), resolution=RES,
                                              learning_rate=1e-4, chunk_size=chunk_size)
            _, loss = step(params, scene.start, scene.direction)
    finally:
        lens_model.render_lens_image = render_image
    return (loss, images[0], params.control_points.grad.clone(),
            params.refractive_index.grad.clone(), params.control_points.detach().clone(),
            params.refractive_index.detach().clone())


def _render(scene):
    with torch.no_grad():
        return render.render_lens_image(scene.patches, scene.refractive_index, scene.start,
                                        scene.direction, scene.screen_plane, resolution=RES)


def _program_events(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("cbtr.")]


def _graph_nodes(root):
    seen, todo = set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


def _loss_graph(scene):
    params = lens_model.params_from_scene(scene)
    loss = lens_model.lens_loss(params, scene.start, scene.direction, scene.screen_plane,
                                _target(), resolution=RES)
    return _graph_nodes(loss.grad_fn)


def test_spans_off_record_nothing(scene):
    """Off: no profiler event, no span time, the parent's graph."""
    with profiling.timing() as earlier:
        pass
    with torch.profiler.profile() as prof:
        _fit_step(scene)
        _render(scene)
    assert _program_events(prof) == []
    assert earlier == {}
    assert not any(name in BOUNDARY_NODES for name in _loss_graph(scene))
    assert profiling.span("cbtr.step") is profiling.span("cbtr.step")


def test_spans_on_put_the_boundary_functions_in_the_graph(scene):
    for switch in (profiling.spans_on, profiling.timing):
        with switch():
            names = _loss_graph(scene)
        assert set(BOUNDARY_NODES) <= names, switch


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_spans_on_show_every_layer_of_a_fit_step(scene, route, request):
    """Every span the CPU path reaches, each backward span inside the step's
    backward, each forward span inside its forward."""
    want = set(FIT_SPANS)
    if route == "kernel":
        request.getfixturevalue("kernel_route")
        want = want - {"cbtr.backward.gather_rows"} | {"cbtr.backward.recompute"}
    with profiling.spans_on(), torch.profiler.profile() as prof:
        _fit_step(scene)
    events = _program_events(prof)
    assert {n for n, _, _ in events} == want
    by_name = {n: (a, b) for n, a, b in events}
    for phase, prefix in (("cbtr.step.backward", "cbtr.backward."),
                          ("cbtr.step.forward", "cbtr.render")):
        lo, hi = by_name[phase]
        inner = [(a, b) for n, a, b in events if n.startswith(prefix)]
        assert inner and all(lo <= a <= b <= hi for a, b in inner), (phase, inner)
    assert [n for n, _, _ in events].count("cbtr.backward.refract") == 2


def test_timing_adds_nested_spans():
    with profiling.timing() as times:
        for _ in range(3):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    time.sleep(0.002)
    assert times["outer"][1] == 3 and times["inner"][1] == 3
    assert times["inner"][0] >= 6_000_000
    assert times["outer"][0] >= times["inner"][0]
    assert set(times) == {"outer", "inner"}


def test_timing_adds_spans_of_other_threads():
    """Spans closed on other threads add to the block's totals under its
    lock: many threads, a short switch interval, no update lost."""
    threads, spans_each = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.timing() as times:
            def work():
                for _ in range(spans_each):
                    with profiling.span("cbtr.thread"):
                        pass

            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert times["cbtr.thread"][1] == threads * spans_each


def test_timing_of_a_fit_step_counts_each_span(scene):
    with profiling.timing() as times:
        _fit_step(scene, optimizer="sgd")
    assert set(times) == FIT_SPANS
    assert times["cbtr.refract"][1] == 2 and times["cbtr.backward.refract"][1] == 2
    assert times["cbtr.step"][1] == 1
    assert times["cbtr.step"][0] >= times["cbtr.step.forward"][0] + times[
        "cbtr.step.backward"][0]


def test_switches_restore_what_they_found():
    with pytest.raises(RuntimeError):
        with profiling.spans_on(), profiling.counting():
            with profiling.timing() as times:
                assert profiling._ON and profiling.counting_enabled()
                raise RuntimeError
    assert not profiling._ON and not profiling.counting_enabled()
    assert profiling._TIMES is None and times == {}
    with profiling.timing() as outer:
        with profiling.timing() as inner:
            with profiling.span("x"):
                pass
        with profiling.span("y"):
            pass
    assert set(inner) == {"x"} and set(outer) == {"y"}


def test_span_decorates_a_function():
    @profiling.span("cbtr.decorated")
    def double(x):
        """Doubles."""
        return 2 * x

    assert double.__name__ == "double" and double.__doc__ == "Doubles."
    assert double(3) == 6
    with profiling.timing() as times:
        assert double(4) == 8
        with profiling.span("cbtr.decorated"):
            assert double(5) == 10
    assert times["cbtr.decorated"][1] == 3


def _evaluated(patches, start, direction, stem):
    """The pairs the kernel evaluates on these rays, the real patches'
    columns: K1's `evaluated_pairs` (listed, gated, each pair's sphere and
    box), K2's `gated_pairs` (listed and gated)."""
    rays_t = cs.pad_rays(start, direction)
    patch_t = cs.pack_patch_table(patches)
    listed = cs.listed_blocks(*cs.tile_block_lists(patches, rays_t), patch_t.shape[0])
    sphere = cs.sphere_hit_pairs(patch_t, rays_t)
    if stem == "sweep_select":
        keep = cs.evaluated_pairs(listed, sphere,
                                  cs.box_hit_pairs(cs.patch_box_table(patches), rays_t))
    else:
        keep = cs.gated_pairs(listed, sphere)
    return int(keep[:, :patches.num_patches].sum())


@pytest.mark.parametrize("stem", ["sweep_select", "winner"])
def test_twins_count_the_pairs_they_evaluate(scene, stem):
    wrapper = cs.sweep_select if stem == "sweep_select" else cw.sweep_winner
    start, direction = scene.start.reshape(-1, 3), scene.direction.reshape(-1, 3)
    cs.reset_pair_counts()
    with profiling.counting():
        wrapper(scene.patches, start, direction)
        wrapper(scene.patches, start, direction)
    counts = cs.pair_counts()
    want = _evaluated(scene.patches, start, direction, stem)
    assert want > 0
    assert counts[stem] == (2 * want, 0)
    assert all(v == (0, 0) for k, v in counts.items() if k != stem)
    cs.reset_pair_counts()
    wrapper(scene.patches, start, direction)
    assert all(v == (0, 0) for v in cs.pair_counts().values())


@pytest.mark.parametrize("optimizer,chunk_size", [("adam", 0), ("sgd", 0), ("sgd", 50)])
def test_every_switch_leaves_a_step_bit_equal(scene, optimizer, chunk_size):
    """Image, loss, gradients and the updated parameters of a step, and a
    render, with spans, timing and counting on against all off."""
    off = _fit_step(scene, optimizer, chunk_size)
    image = _render(scene)
    with contextlib.ExitStack() as stack:
        stack.enter_context(profiling.spans_on())
        stack.enter_context(profiling.timing())
        stack.enter_context(profiling.counting())
        on = _fit_step(scene, optimizer, chunk_size)
        image_on = _render(scene)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert torch.equal(image, image_on)


STEP_PHASES = ("cbtr.step", "cbtr.step.forward", "cbtr.step.backward", "cbtr.step.update")


def _sgd_step(scene, group=None):
    """One data-parallel SGD step (`parallel/sharding.py::sgd_step`, on the
    path of `parallel/multihost.py`'s steps) from the scene's lens, in two
    chunks: (loss, image, grads, new parameters)."""
    from cbtr_tpu_torch.parallel import sharding

    params = lens_model.params_from_scene(scene)
    images = []

    def partial_image(p):
        img = p(scene.start, scene.direction, scene.screen_plane, resolution=RES,
                chunk_size=RES * RES // 2)
        images.append(img.detach().clone())
        return img

    loss, (g_cp, g_n) = sharding.sgd_step(params, partial_image, _target(), 1e-4, group)
    return (loss, images[0], g_cp.clone(), g_n.clone(), params.control_points.detach().clone(),
            params.refractive_index.detach().clone())


def test_timing_of_an_sgd_step_counts_each_phase_once(scene, monkeypatch):
    """The step of `make_multihost_train_step_ortho(None, ...)`: one span
    each of `cbtr.step` and its forward, backward and update, the render
    inside the forward; no all-reduce on a group of one.  With a group the
    gradients' all-reduce is `cbtr.step.allreduce` (a stand-in group whose
    collectives leave their tensors as they are)."""
    from cbtr_tpu_torch.parallel import multihost
    from cbtr_tpu_torch.render.camera import OrthoGrid

    grid = OrthoGrid(center=(0.0, 0.0, 0.0), direction=(1.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
                     width=1.6, height=1.6, res_x=RES, res_y=RES)
    step = multihost.make_multihost_train_step_ortho(
        None, scene.screen_plane, _target(), grid, resolution=RES, learning_rate=1e-4,
        chunk_size=RES * RES // 2)
    params = lens_model.params_from_scene(scene)
    with profiling.timing() as times:
        step(params)
    assert {name: times[name][1] for name in STEP_PHASES} == dict.fromkeys(STEP_PHASES, 1)
    assert "cbtr.step.allreduce" not in times and times["cbtr.render"][1] == 1
    assert times["cbtr.step"][0] >= times["cbtr.step.forward"][0] + times[
        "cbtr.step.backward"][0] + times["cbtr.step.update"][0]

    reduced = []
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, group=None: reduced.append(tuple(t.shape)))
    with profiling.timing() as times:
        _sgd_step(scene, group=object())
    assert {name: times[name][1] for name in STEP_PHASES + ("cbtr.step.allreduce",)} == \
        dict.fromkeys(STEP_PHASES + ("cbtr.step.allreduce",), 1)
    # the image's sum in the forward, then the two gradients in the span
    assert reduced == [(RES, RES), (scene.patches.num_patches, 10, 3), ()]


def test_every_switch_leaves_an_sgd_step_bit_equal(scene):
    """Loss, image, gradients and the updated parameters of the data-parallel
    SGD step with spans, timing and counting on against all off."""
    off = _sgd_step(scene)
    with profiling.spans_on(), profiling.timing(), profiling.counting():
        on = _sgd_step(scene)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert off[2].abs().max() > 0
