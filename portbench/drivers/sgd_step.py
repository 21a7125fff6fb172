"""Driver kind `sgd_step`: a closed loop of the data-parallel SGD step on a
group of one, the loss read back after every step.

Set-up builds one step, the port's
`parallel/multihost.py::make_multihost_train_step_ortho(None, ...)` (its
`sharding.sgd_step`: the image rendered in chunks of `chunk`, the loss, the
backward, no all-reduce on a group of one, `p <- p - lr * grad`), with the
rays made on the card from the beam (`OrthoGrid`, the tiled order, the beam
moved by a seeded sub-pixel offset), and drives it through its first
`first_steps` steps (the first of them with its passes and image captured),
which also warm up every shape; the window goes on with the same step.  Each
unit is one step against the seeded target at `learning_rate`.

The check runs the first steps again after the window, from the first
parameters (copied back into their tensors; SGD keeps no state).  Then it
frees the program's state and lets the plain reference follow those steps
from its own lens, over the same rays in chunks of `reference_chunk`
(`reference/chunked.py`): the lens build, step 1's passes and image, each
step's loss, and step 1's gradients.  Each number is the worse of the
set-up's steps and the re-run.

The gradient is held on the leaves that the reference itself fixes.  At
16.8 M rays a few rays near a grazing or critical path rule many leaves'
gradients: the reference traced in float64 on the program's float32 tables
(`_own_tables`) moves the median leaf's gradient by a quarter of its norm
against the reference on its own float64 tables, and a quarter of the
leaves by most of it.  No float32 program can be held on those leaves.
`grad` is the third quartile of the program's leaf gaps over the stiller
half of the leaves by that spread (`stable_gap`); the gaps' quantiles over
every leaf, and each side's spread, are read beside it.

The update is held exactly: `update` is each step's new leaves against the
reference's update rule applied to the step's own float32 leaves and
gradient.  The parameters' change over the first steps against the
reference's (`fit.py`'s `change`) is read, not compared: it carries the
gradient's spread on every leaf, and no control separates from it.
"""
from __future__ import annotations

import math

import torch

from .. import cell as cells
from .. import compare, inputs, program
from ..window import rate
from .fit import LEAVES

# `stable_gap`'s share of the leaves and its quantile over them: of the
# shares 1/4 to all and the quantiles from the median up, the largest share
# at which every control and planted fault that moves the gradient (the
# bf16 sweep and tables, altered winners, half the patches' gradients
# zeroed, half the rays) reads above the limit set by the calibration's
# rule (PERF.md, robot450-train4k)
STABLE_SHARE, STABLE_QUANTILE = 0.5, 0.75


class State:
    SPANS = program.SPANS

    def __init__(self, cell, seed: int, device):
        from cbtr_tpu_torch.models.lens_model import params_from_scene
        from cbtr_tpu_torch.parallel.multihost import make_multihost_train_step_ortho
        from cbtr_tpu_torch.render.camera import OrthoGrid

        t = cell.traffic
        self.cell, self.device = cell, torch.device(device)
        self.mesh = cells.mesh_path(cell)
        self.beam = inputs.beam(t, seed)
        self.n_rays = int(t["res"]) ** 2
        self.screen = inputs.screen_plane(t, device)
        self.target = inputs.target(t, seed, self.n_rays, device)
        self.lr = float(t["learning_rate"])
        scene = program.lens_scene(cell, self.mesh, device)
        self.patches = scene.patches.detach()
        self.params = params_from_scene(scene)
        b = self.beam
        grid = OrthoGrid(center=b["center"], direction=b["direction"], up=b["up"],
                         width=b["width"], height=b["width"], res_x=b["res"], res_y=b["res"])
        self.step = make_multihost_train_step_ortho(
            None, self.screen, self.target, grid, resolution=int(t["image_res"]),
            extent=float(t["extent"]), learning_rate=self.lr, chunk_size=int(t["chunk"]))
        self.initial = self._leaves()
        self.runs = [self._first_steps()]
        self.readings = {}

    def _leaves(self) -> dict:
        return {k: getattr(self.params, k).detach().clone() for k in LEAVES}

    def _first_steps(self) -> dict:
        """The first steps from the parameters' present values: step 1's
        passes and image; each step's loss, gradients and leaves before and
        after; the change over them all."""
        from cbtr_tpu_torch.models import lens_model

        first = self._leaves()
        images = []
        render = lens_model.render_lens_image

        def kept(*args, **kwargs):
            img = render(*args, **kwargs)
            images.append(img.detach().clone())
            return img

        lens_model.render_lens_image = kept
        try:
            with program.capture_passes() as passes:
                steps = [self._recorded_step()]
        finally:
            lens_model.render_lens_image = render
        for _ in range(int(self.cell.traffic["first_steps"]) - 1):
            steps.append(self._recorded_step())
        return {"passes": passes, "image": images[0], "steps": steps,
                "change": {k: steps[-1]["after"][k] - first[k] for k in LEAVES}}

    def _recorded_step(self) -> dict:
        before = self._leaves()
        _, loss, grads = self.step(self.params)
        return {"loss": float(loss), "before": before, "after": self._leaves(),
                "grads": {k: g.detach().clone() for k, g in zip(LEAVES, grads)}}

    def unit_loss(self) -> float:
        _, loss, _ = self.step(self.params)
        return float(loss)

    def unit(self):
        loss = self.unit_loss()
        return self.n_rays, math.isfinite(loss)

    def sample_rays(self, idx):
        """The unit's rays at flat indices idx (float32, as the program makes
        them)."""
        from ..reference.scene import ortho_rays

        return ortho_rays(self.beam, idx)

    def end_to_end(self, win) -> dict:
        return {"fit_rays_per_s": rate(win)}

    def check(self) -> dict:
        from ..reference import chunked
        from ..reference import scene as ref_scene

        with torch.no_grad():
            for k in LEAVES:
                getattr(self.params, k).copy_(self.initial[k])
        self.runs.append(self._first_steps())
        patches = self.patches
        self.params = self.step = self.patches = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        t, cfg = self.cell.traffic, self.cell.config
        ref_patches = ref_scene.build_patches(self.mesh, cfg["lens_center"], bool(cfg["refine"]),
                                              self.device)
        numbers = {"patch_build": compare.build_gap(patches, ref_patches)}
        del ref_patches
        lens = ref_scene.build_lens(cfg, self.mesh, self.device)
        idx = torch.arange(self.n_rays, device=self.device)
        start, direction = (x.double() for x in ref_scene.ortho_rays(self.beam, idx))
        del idx
        screen, target = self.screen.double(), self.target.double()
        extent, chunk = float(t["extent"]), int(t["reference_chunk"])
        params = {k: getattr(lens, k) for k in LEAVES}
        before, losses = dict(params), []
        runs = self.runs
        for step in range(len(runs[0]["steps"])):
            loss, g_cp, g_ri, trace = chunked.loss_and_grads(
                lens._replace(**params), start, direction, screen, target, extent, chunk,
                keep_rays=step == 0)
            losses.append(float(loss))
            if step == 0:
                for k, r in enumerate(program.reference_passes(trace), 1):
                    numbers[f"pass{k}"] = max(compare.pass_gap(run["passes"][k - 1], r)
                                              for run in runs)
                numbers["image"] = max(compare.image_gap(run["image"], trace.image)
                                       for run in runs)
                ref_grad = compare.leaf_norms(g_cp, g_ri)
                # what the learning rate was chosen on: step 1's largest
                # control-point gradient and move, and the gradient's norm
                first = runs[0]["steps"][0]
                self.readings.update({
                    "grad_cp_max": float(first["grads"]["control_points"].abs().max()),
                    "grad_cp_norm": float(first["grads"]["control_points"].norm()),
                    "move_cp_max": float((first["after"]["control_points"]
                                          - first["before"]["control_points"]).abs().max()),
                    "grad_cp_max.reference": float(g_cp.abs().max()),
                    "grad_cp_norm.reference": float(g_cp.norm())})
                program_grads = [compare.leaf_norms(*(run["steps"][0]["grads"][k]
                                                      for k in LEAVES)) for run in runs]
                for run in runs:
                    del run["passes"]
                mixed = self._own_tables(patches, lens, start, direction, screen, target,
                                         extent, chunk)
                self._read("grad", program_grads, ref_grad, ref_grad)
                self._read("look.trace", program_grads, mixed, mixed)
                self._read("look.build", [mixed], ref_grad, ref_grad)
            del trace
            params = chunked.sgd_update(params, {"control_points": g_cp,
                                                 "refractive_index": g_ri}, self.lr)
        numbers["loss"] = max(compare.relative_gap(s["loss"], b)
                              for run in runs for s, b in zip(run["steps"], losses))
        numbers["grad"] = max(stable_gap(p, ref_grad, mixed) for p in program_grads)
        numbers["update"] = max(update_gap(step, self.lr) for run in runs
                                for step in run["steps"])
        self._read("change", [compare.leaf_norms(*(run["change"][k] for k in LEAVES))
                              for run in runs],
                   compare.leaf_norms(*(params[k] - before[k] for k in LEAVES)), ref_grad)
        return numbers

    def _read(self, name, program_runs, reference, ref_grad):
        """`readings[name.<quantile>]`: the leaf gap at each of
        READ_QUANTILES, the worse of the program's runs."""
        for label, q in READ_QUANTILES.items():
            self.readings[f"{name}.{label}"] = max(
                compare.leaf_gap(p, reference, ref_grad, q) for p in program_runs)

    def _own_tables(self, patches, lens, start, direction, screen, target, extent, chunk):
        """The reference's step-1 leaf norms, traced in float64 on the
        program's float32 tables (`fit.py`'s look)."""
        from ..reference import chunked

        own = lens._replace(**{f: getattr(patches, f).to(torch.float64)
                               for f in ("control_points", "underlying", "dividers",
                                         "bary_inverse", "heights", "deriv_b")},
                            neighbours=patches.neighbours.long())
        _, g_cp, g_ri, _ = chunked.loss_and_grads(own, start, direction, screen, target,
                                                  extent, chunk)
        self.readings["look.grad_cp_max"] = float(g_cp.abs().max())
        return compare.leaf_norms(g_cp, g_ri)


def stable_gap(program, reference, own_tables, share: float = STABLE_SHARE,
               q: float = STABLE_QUANTILE) -> float:
    """`compare.leaf_gap`'s gaps, their q-quantile over the share of the
    leaves whose reference gradient holds stillest when the reference is
    traced on the program's float32 tables (`own_tables`) in place of its
    own float64 ones: the leaves that the float64 reference itself fixes.
    Each argument is `compare.leaf_norms`'; leaves are left out by the
    reference's gradient as `compare.leaf_gap` leaves them out."""
    ref = reference
    kept = ref >= float(ref[ref > 0.0].median()) / 1000.0
    median = float(ref[ref > 0.0].median())
    spread = ((own_tables - ref).abs() / ref.clamp_min(median))[kept]
    gaps = ((program - ref).abs() / ref.clamp_min(median))[kept]
    stillest = spread.argsort()[:max(1, round(share * int(kept.sum())))]
    return float(torch.quantile(gaps[stillest], q))


READ_QUANTILES = {"worst": 1.0, "q95": 0.95, "q90": 0.9, "q75": 0.75, "median": 0.5,
                  "q25": 0.25, "q10": 0.1}


def update_gap(step: dict, lr: float) -> float:
    """The largest gap between a step's new leaves and the reference's
    update rule (`chunked.sgd_update`) applied to its old leaves and its
    gradient in their own float32, over the largest move that rule makes: 0
    where the two are equal bit for bit, 1 where the step left the leaf that
    moves most where it was."""
    from ..reference import chunked

    want = chunked.sgd_update(step["before"], step["grads"], lr)
    gap = max(float((step["after"][k] - want[k]).abs().max()) for k in LEAVES)
    move = max(float((want[k] - step["before"][k]).abs().max()) for k in LEAVES)
    return gap / move if move else gap


def setup(cell, seed: int, device) -> State:
    return State(cell, seed, device)
