"""The control and the faults that `correct` has to catch, each planted in
the port for the length of a `with` block (module attributes swapped and
put back).  The calibration (`calibrate.py`) reads them at a cell's own size
on the card; the tests (`tests/test_correct_fails.py`) see each turn a run's
`correct` false at a size a CPU holds.

* `control`: the port's own lower-precision path, `config.bf16_sweep` (the
  winner search's sums in bfloat16);
* `control_build`: the lens's patch tables rounded to bfloat16 as the port
  builds them (the port has no lower-precision build of its own);
* `unchanged`: the fit step computes its loss and gradients and returns
  the parameters unchanged (the optimizer never steps);
* `half_batch`: each render or step traces the first half of its rays only;
* `altered`: every 11th ray's winning patch id is altered where the winner
  search produces it.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _swapped(module, attr, make):
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


@contextlib.contextmanager
def control():
    from cbtr_tpu_torch.ops.intersect import MODES, using_mode

    with using_mode(MODES["bf16"]):
        yield


@contextlib.contextmanager
def control_build():
    import torch
    from cbtr_tpu_torch.models import scenes

    def make(original):
        def build(*args, **kwargs):
            return original(*args, **kwargs).map(
                lambda x: x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x)
        return build

    with _swapped(scenes, "build_from_trimesh", make):
        yield


@contextlib.contextmanager
def unchanged():
    from cbtr_tpu_torch.models import lens_model

    def make(original):
        def make_opt_train_step(screen_plane, target, resolution=128, extent=4.0,
                                chunk_size=0):
            def step(params, opt, start, direction):
                opt.zero_grad(set_to_none=True)
                loss = lens_model.lens_loss(params, start, direction, screen_plane, target,
                                            resolution=resolution, extent=extent,
                                            chunk_size=chunk_size)
                loss.backward()
                return params, opt, loss.detach()
            return step
        return make_opt_train_step

    with _swapped(lens_model, "make_opt_train_step", make):
        yield


@contextlib.contextmanager
def half_batch():
    from cbtr_tpu_torch.models import lens_model
    from cbtr_tpu_torch.parallel import multihost

    def halve(original):
        def render(patches, refractive_index, start, direction, *args, **kwargs):
            n = start.shape[0] // 2
            return original(patches, refractive_index, start[:n], direction[:n], *args,
                            **kwargs)
        return render

    with _swapped(lens_model, "render_lens_image", halve), \
            _swapped(multihost, "render_lens_image", halve):
        yield


@contextlib.contextmanager
def altered():
    import torch
    from cbtr_tpu_torch.ops import intersect

    def make(original):
        def winner_chunk(patches, start, direction, backend, tables=None):
            any_hit, win = original(patches, start, direction, backend, tables=tables)
            every = torch.arange(win.shape[0], device=win.device) % 11 == 0
            moved = (win + 1) % patches.num_patches
            return any_hit, torch.where(every & any_hit, moved, win).to(win.dtype)
        return winner_chunk

    with _swapped(intersect, "_winner_chunk", make):
        yield


FAULTS = {"control": control, "control_build": control_build, "unchanged": unchanged,
          "half_batch": half_batch, "altered": altered}
