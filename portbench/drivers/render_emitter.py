"""Driver kind `render_emitter`: a closed loop of forward renders of a point
source's rays made on the card (the car-lamp case).

Each unit is one call of the port's
`parallel/multihost.py::render_multihost_emitter` on a group of one (the
path of its `benchmarks/emitter4k.py`): a `DeviceEmitter` at the lens centre
plus `source_from_lens`, with `belts` belts, `n_rays` rays and the run's
seed as its own, synthesizes its bin-sorted rays on the device; they are
traced through the lens in chunks of `chunk`, and each live ray's weight is
splatted into an image_res^2 image; then synchronised.  Every render of a
run is the same call on the same rays, so the window's last image stands
for all.

The check renders once more with the passes captured (the image has to
equal the window's bit for bit), frees the program's state, and holds the
lens build, both passes and the image against the plain reference's float64
weighted render of the reference emitter's own rays
(`reference/emitter.py`).  Beside them it reads, uncompared, the largest
gap between the program's rays and the reference's and the share of rays
the reference refracts in both passes.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from .. import cell as cells
from .. import compare, inputs, program
from ..window import rate

SYNTHESIS = ("emitter_rays", "cbtr_tpu_torch.render.emitters", "synthesize")


def spans() -> tuple:
    """The render's spans, and the ray synthesis's where the port has it as
    a module attribute."""
    module = importlib.import_module(SYNTHESIS[1])
    return program.SPANS + ((SYNTHESIS,) if hasattr(module, SYNTHESIS[2]) else ())


def emitter_spec(cell, seed: int) -> dict:
    """The emitter of the cell's mix: at the configuration's lens centre plus
    `source_from_lens` (float32, as the port places its lens), the run's
    seed."""
    t = cell.traffic
    origin = (np.asarray(cell.config["lens_center"], np.float32)
              + np.asarray(t["source_from_lens"], np.float32))
    return {"origin": tuple(origin.tolist()), "belts": int(t["belts"]),
            "n_rays": int(t["n_rays"]), "seed": int(seed)}


class State:
    def __init__(self, cell, seed: int, device):
        from cbtr_tpu_torch.parallel.multihost import render_multihost_emitter
        from cbtr_tpu_torch.render.emitters import DeviceEmitter

        t = cell.traffic
        self.cell, self.device = cell, torch.device(device)
        self.SPANS = spans()
        self.mesh = cells.mesh_path(cell)
        self.spec = emitter_spec(cell, seed)
        self.emitter = DeviceEmitter(**self.spec)
        self.n_rays = self.emitter.n_rays
        self.screen = inputs.screen_plane(t, device)
        self.scene = program.lens_scene(cell, self.mesh, device)

        def render():
            with torch.no_grad():
                return render_multihost_emitter(
                    None, self.scene.patches, self.scene.refractive_index, self.emitter,
                    self.screen, resolution=int(t["image_res"]), extent=float(t["extent"]),
                    chunk_size=int(t["chunk"]))

        self.render = render
        self.last = None
        self.readings = {}
        self.unit()                       # the one warm-up: every shape of the cell

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def unit(self):
        self.last = self.render()
        self._sync()
        return self.n_rays, True

    def end_to_end(self, win) -> dict:
        return {"render_rays_per_s": rate(win)}

    def sample_rays(self, idx):
        """The unit's rays at flat indices idx (float32, as the program makes
        them): start and direction."""
        from ..reference.emitter import rays

        start, direction, _ = rays(self.spec, idx)
        return start, direction

    def check(self) -> dict:
        from ..reference import emitter as ref_emitter
        from ..reference import scene as ref_scene

        with program.capture_passes() as passes:
            image = self.render()
        self._sync()
        numbers = {"rerun": compare.rerun_gap(self.last, image)}
        patches = self.scene.patches.detach()
        self.scene = self.render = self.last = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        t = self.cell.traffic
        lens = ref_scene.build_lens(self.cell.config, self.mesh, self.device)
        ref_patches = ref_scene.build_patches(self.mesh, self.cell.config["lens_center"],
                                              bool(self.cell.config["refine"]), self.device)
        numbers["patch_build"] = compare.build_gap(patches, ref_patches)
        del patches, ref_patches
        idx = torch.arange(self.n_rays, device=self.device)
        start, direction, weight = ref_emitter.rays(self.spec, idx)
        with torch.no_grad():
            ours = self.emitter.rays_at(idx)
        self.readings["rays_gap"] = max(float((a - b).abs().max())
                                        for a, b in zip(ours, (start, direction, weight)))
        del ours
        ref_image, ref_trace = ref_emitter.render(
            lens, start, direction, weight, self.screen.double(), float(t["extent"]),
            int(t["image_res"]), chunk=int(t.get("reference_chunk", 1 << 20)))
        for k, (p, r) in enumerate(zip(passes, program.reference_passes(ref_trace)), 1):
            numbers[f"pass{k}"] = compare.pass_gap(p, r)
        self.readings["through_share"] = float(
            ((ref_trace.status1 > 0) & (ref_trace.status2 > 0)).double().mean())
        numbers["image"] = compare.image_gap(image, ref_image)
        return numbers


def setup(cell, seed: int, device) -> State:
    return State(cell, seed, device)
