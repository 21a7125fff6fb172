"""Driver kind `render_ortho`: a closed loop of forward renders of a
collimated beam made on the card.

Each unit is one call of the port's
`parallel/multihost.py::render_multihost_ortho` on a group of one (the path
of its `benchmarks/render4k.py`): res x res rays synthesized on the device
from the beam, traced through the lens in chunks of `chunk` and splatted
into an image_res^2 image, then synchronised.  Every render of a run is the
same call on the same beam, so the window's last image stands for all.

The check renders once more with the passes captured (the image has to equal
the window's bit for bit), frees the program's state, and holds the lens
build, both passes and the image against the plain reference.
"""
from __future__ import annotations

import torch

from .. import cell as cells
from .. import compare, inputs, program
from ..window import rate


class State:
    SPANS = program.SPANS

    def __init__(self, cell, seed: int, device):
        from cbtr_tpu_torch.parallel.multihost import render_multihost_ortho
        from cbtr_tpu_torch.render.camera import OrthoGrid

        t = cell.traffic
        self.cell, self.device = cell, torch.device(device)
        self.mesh = cells.mesh_path(cell)
        self.beam = inputs.beam(t, seed)
        self.screen = inputs.screen_plane(t, device)
        self.scene = program.lens_scene(cell, self.mesh, device)
        b = self.beam
        self.grid = OrthoGrid(center=b["center"], direction=b["direction"], up=b["up"],
                              width=b["width"], height=b["width"], res_x=b["res"],
                              res_y=b["res"])
        self.n_rays = self.grid.n_rays

        def render():
            with torch.no_grad():
                return render_multihost_ortho(
                    None, self.scene.patches, self.scene.refractive_index, self.grid,
                    self.screen, resolution=int(t["image_res"]), extent=float(t["extent"]),
                    chunk_size=int(t["chunk"]))

        self.render = render
        self.last = None
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
        them)."""
        from ..reference.scene import ortho_rays

        return ortho_rays(self.beam, idx)

    def check(self) -> dict:
        from ..reference import scene as ref_scene
        from ..reference import tracer

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
        start, direction = (x.double() for x in ref_scene.ortho_rays(self.beam, idx))
        ref_image, ref_trace = tracer.render(lens, start, direction, self.screen.double(),
                                             float(t["extent"]), int(t["image_res"]),
                                             chunk=int(t.get("reference_chunk", 1 << 20)))
        for k, (p, r) in enumerate(zip(passes, program.reference_passes(ref_trace)), 1):
            numbers[f"pass{k}"] = compare.pass_gap(p, r)
        numbers["image"] = compare.image_gap(image, ref_image)
        return numbers


def setup(cell, seed: int, device) -> State:
    return State(cell, seed, device)
