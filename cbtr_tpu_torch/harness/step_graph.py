"""The fit step's CUDA graph against its eager body, on the card.

`models.lens_model.make_opt_train_step` captures its loss and backward as
one CUDA graph on its second eligible call and replays it from then on
(`OptTrainStep`).  `compare` runs that step and an eager twin of its body
(`eager_twin`: the loss, its backward and `opt.step()`, as the step ran
before it had a graph) on two copies of one lens, Adam on each, step by
step, and holds the winners of each refraction, the loss, the gradients,
the parameters and the kernels' launches of each step of the two equal.
After the first steps it restarts both in place (the parameters put back,
Adam's state zeroed), runs one step with `lens_model.render_lens_image`
wrapped (so the graphed step runs eagerly) and replays again: the pattern
of the benchmark's check.  `timing()` counts the step's paths
(`cbtr.step.capture`, `.replay`, `.eager`).

`tests/test_torch_step_graph_card.py` and chip_smoke phase u run it on the
headline lens (robot, 450 patches, K1) and the refined one (1800, K2).
"""
from __future__ import annotations

import contextlib
import time

import torch

PATHS = ("capture", "replay", "eager")


def eager_twin(screen_plane, target, resolution: int = 128, extent: float = 4.0,
               chunk_size: int = 0):
    """The fit step's eager body: (params, opt, start, direction) -> (params,
    opt, loss)."""
    from ..models import lens_model

    def step(params, opt, start, direction):
        opt.zero_grad(set_to_none=True)
        loss = lens_model.lens_loss(params, start, direction, screen_plane, target,
                                    resolution=resolution, extent=extent,
                                    chunk_size=chunk_size)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    return step


@contextlib.contextmanager
def recorded_winners():
    """While on, each call of the winner kernels' wrappers (K1 and K2, as
    `ops.intersect._winner_route` finds them) appends its winners to the
    yielded list.  Those of a captured call live in the graph's pool, and
    each replay writes them again.  The wrappers lie outside the step's
    `GRAPH_PATH`, so wrapping them leaves its replays alone."""
    from ..ops import cuda_sweep, cuda_winner

    calls = []
    originals = cuda_sweep.sweep_select, cuda_winner.sweep_winner

    def recorded(fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append(out[1])
            return out
        return wrapper

    cuda_sweep.sweep_select, cuda_winner.sweep_winner = map(recorded, originals)
    try:
        yield calls
    finally:
        cuda_sweep.sweep_select, cuda_winner.sweep_winner = originals


@contextlib.contextmanager
def hooked_render():
    """`lens_model.render_lens_image` wrapped by a pass-through, as a caller
    that keeps each image would wrap it."""
    from ..models import lens_model

    original = lens_model.render_lens_image

    def render(*args, **kwargs):
        return original(*args, **kwargs)

    lens_model.render_lens_image = render
    try:
        yield
    finally:
        lens_model.render_lens_image = original


def seeded_target(resolution: int, n_rays: int, seed: int, device) -> torch.Tensor:
    """A seeded non-negative target image holding about half the rays."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    img = torch.rand((resolution, resolution), generator=gen, dtype=torch.float32)
    return (img * (0.5 * n_rays / float(img.sum()))).to(device)


def _leaves(params) -> tuple:
    return tuple(p.detach().clone() for p in (params.control_points, params.refractive_index))


def _grads(params) -> tuple:
    return tuple(p.grad.detach().clone() for p in (params.control_points,
                                                   params.refractive_index))


def _gap(a, b) -> float:
    """max |a - b| / max(max |b|, tiny)."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def compare(scene, steps: int = 6, after_restart: int = 2, resolution: int = 128,
            learning_rate: float = 1e-5, seed: int = 0, chunk_size: int = 0) -> dict:
    """`steps` Adam steps of the graphed step against its eager twin, on two
    lenses built from `scene`, then a restart in place, one hooked step and
    `after_restart` more.  Returns the record: each step's path, whether
    every winner, loss, gradient, parameter and launch count was equal, the
    largest relative gap of any of them, the path counts before and after
    the restart and the peak device memory."""
    from ..models import lens_model
    from ..ops import cuda_lib
    from ..utils import profiling

    device = scene.start.device
    start, direction = scene.start, scene.direction
    target = seeded_target(resolution, start.shape[0], seed, device)
    sides = {}
    for name, make in (("graphed", lens_model.make_opt_train_step), ("twin", eager_twin)):
        params = lens_model.params_from_scene(scene)
        opt = torch.optim.Adam([params.control_points, params.refractive_index],
                               lr=learning_rate)
        sides[name] = {"params": params, "opt": opt, "initial": _leaves(params),
                       "step": make(scene.screen_plane, target, resolution=resolution,
                                    chunk_size=chunk_size)}
    equal, gap, paths, kept = True, 0.0, [], []
    counts = []

    def run_pair():
        nonlocal equal, gap
        out = {}
        for name, side in sides.items():
            n_calls = len(calls)
            path_before = {p: times.get(f"cbtr.step.{p}", [0, 0])[1] for p in PATHS}
            (_, _, loss), launches = cuda_lib.counted(
                lambda: side["step"](side["params"], side["opt"], start, direction))
            torch.cuda.synchronize(device)
            new = calls[n_calls:]
            path = next((p for p in PATHS
                         if times.get(f"cbtr.step.{p}", [0, 0])[1] > path_before[p]), None)
            out[name] = {"path": path, "new": new,
                         "launches": launches,
                         "loss": loss.clone(), "grads": _grads(side["params"]),
                         "leaves": _leaves(side["params"])}
        g, t = out["graphed"], out["twin"]
        passes = len(t["new"])
        if g["path"] == "capture":
            kept[:] = g["new"][-passes:]
            # the capture call ran a warm-up and the captured launches
            want = {k: 2 * v for k, v in t["launches"].items()}
        else:
            want = t["launches"]
        winners = [w.clone() for w in (g["new"][-passes:] if g["new"] else kept)]
        pairs = list(zip(winners, t["new"])) + [(g["loss"], t["loss"])] + list(
            zip(g["grads"] + g["leaves"], t["grads"] + t["leaves"]))
        same = len(winners) == passes and all(torch.equal(a, b) for a, b in pairs) \
            and g["launches"] == want
        equal = equal and same
        gap = max([gap] + [_gap(a.float(), b.float()) for a, b in pairs[passes:]])
        paths.append(g["path"])

    def restart():
        for side in sides.values():
            with torch.no_grad():
                for p, v in zip((side["params"].control_points,
                                 side["params"].refractive_index), side["initial"]):
                    p.copy_(v)
            for state in side["opt"].state.values():
                for value in state.values():
                    value.zero_()

    torch.cuda.reset_peak_memory_stats(device)
    with recorded_winners() as calls, profiling.timing() as times:
        for _ in range(steps):
            run_pair()
        counts.append({p: times.get(f"cbtr.step.{p}", [0, 0])[1] for p in PATHS})
        restart()
        with hooked_render():
            run_pair()
        for _ in range(after_restart):
            run_pair()
        counts.append({p: times.get(f"cbtr.step.{p}", [0, 0])[1] - counts[0][p]
                       for p in PATHS})
    return {"rays": start.shape[0], "patches": scene.patches.num_patches, "paths": paths,
            "equal": equal, "max_rel_gap": gap, "counts": counts[0],
            "counts_after_restart": counts[1],
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}


def step_ms(scene, steps: int = 20, resolution: int = 128, learning_rate: float = 1e-5,
            seed: int = 0, chunk_size: int = 0) -> dict:
    """Host-clock ms a step, the loss read back each step (as `fit_lens` and
    the benchmark's fit cells read it), of the graphed step once it
    replays and of its eager twin, in turns (eager, graphed, graphed,
    eager), `steps` steps a turn; each side on a lens of its own."""
    from ..models import lens_model

    device = scene.start.device
    target = seeded_target(resolution, scene.start.shape[0], seed, device)
    sides = {}
    for name, make in (("graphed", lens_model.make_opt_train_step), ("eager", eager_twin)):
        params = lens_model.params_from_scene(scene)
        opt = torch.optim.Adam([params.control_points, params.refractive_index],
                               lr=learning_rate)
        step = make(scene.screen_plane, target, resolution=resolution, chunk_size=chunk_size)
        sides[name] = (step, params, opt)
        for _ in range(3):          # warm-up, capture, one replay
            float(step(params, opt, scene.start, scene.direction)[2])
    out = {name: [] for name in sides}
    for name in ("eager", "graphed", "graphed", "eager"):
        step, params, opt = sides[name]
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        for _ in range(steps):
            float(step(params, opt, scene.start, scene.direction)[2])
        out[name].append((time.perf_counter() - t) / steps * 1e3)
    return out


def graphed_peak(scene, chunk_size: int, resolution: int = 128,
                 learning_rate: float = 1e-5, seed: int = 0) -> dict:
    """The peak device memory of the graphed step over its warm-up, capture
    and first replays, what it holds between steps (allocated: the static
    rays, gradients and loss, the lens and Adam's state; reserved: with the
    graph's pool), the same after the step is dropped and the cache
    emptied, and ms a replay."""
    from ..models import lens_model

    device = scene.start.device
    target = seeded_target(resolution, scene.start.shape[0], seed, device)
    params = lens_model.params_from_scene(scene)
    opt = torch.optim.Adam([params.control_points, params.refractive_index], lr=learning_rate)
    step = lens_model.make_opt_train_step(scene.screen_plane, target, resolution=resolution,
                                          chunk_size=chunk_size)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device), torch.cuda.memory_reserved(device)
    torch.cuda.reset_peak_memory_stats(device)
    losses = [float(step(params, opt, scene.start, scene.direction)[2]) for _ in range(3)]
    t = time.perf_counter()
    losses.append(float(step(params, opt, scene.start, scene.direction)[2]))
    replay_ms = (time.perf_counter() - t) * 1e3
    out = {"rays": scene.start.shape[0], "chunk": chunk_size, "losses": losses,
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30, "replay_ms": replay_ms}

    def held(when):
        out[f"{when}_allocated_gib"] = (torch.cuda.memory_allocated(device) - base[0]) / 2**30
        out[f"{when}_reserved_gib"] = (torch.cuda.memory_reserved(device) - base[1]) / 2**30

    torch.cuda.empty_cache()
    held("held")
    del step, opt, params
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    held("dropped")
    return out
