"""Driver kind `fit`: a closed loop of Adam fit steps, the loss read back
after every step as the port's `models/fit.py::fit_lens` reads it.

Set-up builds one step object, the port's
`models/lens_model.py::make_opt_train_step` with `torch.optim.Adam` over the
lens's control points and refractive index (`fit_lens(optimizer="adam")`),
and drives it through its first `first_steps` steps (the first of them with
its passes and image captured), which also warm up every shape; the window
goes on with the same object.  Each unit is one step on res x res collimated
rays (the tiled order, the beam moved by a seeded sub-pixel offset) against
the seeded target, at `learning_rate`.

The check runs the first steps again after the window, through the same
step object: the parameters put back to their first values and Adam's
moments and step count zeroed, in place.  Then it frees the program's state
and lets the plain reference follow those steps from its own lens: the lens
build, step 1's passes and image, each step's loss, step 1's gradients (as
Adam read them, `.grad` after the step) and the parameters' change over the
first steps.  Each number is the worse of the set-up's steps and the re-run.
"""
from __future__ import annotations

import math

import torch

from .. import cell as cells
from .. import compare, inputs, program
from ..window import percentile, rate

LEAVES = ("control_points", "refractive_index")
# the quantile of the leaves' gaps that `grad` and `change` compare: the
# highest that separates sound runs from the controls in both fit cells, since
# a float32 rounding of the tables moves a quarter of the leaves' gradients by
# most of their norm; the others (1.0: the worst leaf) are read beside them
GRAD_QUANTILE, CHANGE_QUANTILE = 0.5, 0.75
READ_QUANTILES = {"worst": 1.0, "q95": 0.95, "q90": 0.9, "q75": 0.75, "median": 0.5}


class State:
    SPANS = program.SPANS
    # set by the calibration: also trace the reference on the program's own
    # float32 patch tables, to part the build's share of `grad` from the trace's
    look = False

    def __init__(self, cell, seed: int, device):
        from cbtr_tpu_torch.models.lens_model import make_opt_train_step, params_from_scene

        from ..reference.scene import ortho_rays

        t = cell.traffic
        self.cell, self.device = cell, torch.device(device)
        self.mesh = cells.mesh_path(cell)
        self.beam = inputs.beam(t, seed)
        self.n_rays = int(t["res"]) ** 2
        self.start, self.direction = ortho_rays(
            self.beam, torch.arange(self.n_rays, device=self.device))
        self.screen = inputs.screen_plane(t, device)
        self.target = inputs.target(t, seed, self.n_rays, device)
        self.lr = float(t["learning_rate"])
        scene = program.lens_scene(cell, self.mesh, device)
        self.patches = scene.patches.detach()
        self.params = params_from_scene(scene)
        self.opt = torch.optim.Adam([self.params.control_points, self.params.refractive_index],
                                    lr=self.lr)
        self.step = make_opt_train_step(self.screen, self.target,
                                        resolution=int(t["image_res"]),
                                        extent=float(t["extent"]),
                                        chunk_size=int(t.get("chunk", 0)))
        self.initial = self._leaves()
        self.runs = [self._first_steps()]
        self.readings = {}

    def _leaves(self) -> dict:
        return {k: getattr(self.params, k).detach().clone() for k in LEAVES}

    def _first_steps(self) -> dict:
        """The first steps from the parameters' present values: step 1's
        passes, image and gradients, each step's loss, the change."""
        from cbtr_tpu_torch.models import lens_model

        before = self._leaves()
        images = []
        render = lens_model.render_lens_image

        def kept(*args, **kwargs):
            img = render(*args, **kwargs)
            images.append(img.detach().clone())
            return img

        lens_model.render_lens_image = kept
        try:
            with program.capture_passes() as passes:
                losses = [self.unit_loss()]
        finally:
            lens_model.render_lens_image = render
        grads = {k: getattr(self.params, k).grad.detach().clone() for k in LEAVES}
        for _ in range(int(self.cell.traffic["first_steps"]) - 1):
            losses.append(self.unit_loss())
        change = {k: v - before[k] for k, v in self._leaves().items()}
        return {"passes": passes, "image": images[0], "grads": grads, "losses": losses,
                "change": change}

    def _restart(self):
        """The parameters back to their first values and Adam's state
        zeroed, each tensor in place, so that the step object meets them
        where it met them first."""
        with torch.no_grad():
            for k in LEAVES:
                getattr(self.params, k).copy_(self.initial[k])
        for state in self.opt.state.values():
            for value in state.values():
                value.zero_()

    def unit_loss(self) -> float:
        _, _, loss = self.step(self.params, self.opt, self.start, self.direction)
        return float(loss)

    def unit(self):
        loss = self.unit_loss()
        return self.n_rays, math.isfinite(loss)

    def sample_rays(self, idx):
        """The unit's rays at indices idx."""
        return self.start[idx], self.direction[idx]

    def end_to_end(self, win) -> dict:
        return {"fit_rays_per_s": rate(win),
                "fit_step_ms_p95": 1e3 * percentile(win.unit_s, 95.0)}

    def check(self) -> dict:
        from ..reference import scene as ref_scene
        from ..reference import tracer
        from ..reference.optim import adam_step

        self._restart()
        self.runs.append(self._first_steps())
        patches = self.patches
        self.params = self.opt = self.step = self.patches = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        t, cfg = self.cell.traffic, self.cell.config
        ref_patches = ref_scene.build_patches(self.mesh, cfg["lens_center"], bool(cfg["refine"]),
                                              self.device)
        numbers = {"patch_build": compare.build_gap(patches, ref_patches)}
        del ref_patches
        lens = ref_scene.build_lens(cfg, self.mesh, self.device)
        start, direction = self.start.double(), self.direction.double()
        screen, target = self.screen.double(), self.target.double()
        extent = float(t["extent"])
        params = {"control_points": lens.control_points,
                  "refractive_index": lens.refractive_index}
        before, adam, losses = dict(params), {}, []
        runs = self.runs
        for step in range(len(runs[0]["losses"])):
            loss, g_cp, g_ri, trace = tracer.loss_and_grads(
                lens._replace(**params), start, direction, screen, target, extent)
            losses.append(float(loss))
            if step == 0:
                for k, r in enumerate(program.reference_passes(trace), 1):
                    numbers[f"pass{k}"] = max(compare.pass_gap(run["passes"][k - 1], r)
                                              for run in runs)
                numbers["image"] = max(compare.image_gap(run["image"], trace.image)
                                       for run in runs)
                ref_grad = compare.leaf_norms(g_cp, g_ri)
                self._read("grad", [compare.leaf_norms(*(run["grads"][k] for k in LEAVES))
                                    for run in runs], ref_grad, ref_grad)
                if self.look:
                    self._look(patches, lens, start, direction, screen, target, extent,
                               ref_grad)
            del trace
            params = adam_step(params, {"control_points": g_cp, "refractive_index": g_ri},
                               adam, self.lr)
        numbers["loss"] = max(compare.relative_gap(a, b)
                              for run in runs for a, b in zip(run["losses"], losses))
        self._read("change", [compare.leaf_norms(*(run["change"][k] for k in LEAVES))
                              for run in runs],
                   compare.leaf_norms(*(params[k] - before[k] for k in LEAVES)), ref_grad)
        numbers["grad"] = self.readings[f"grad.{_label(GRAD_QUANTILE)}"]
        numbers["change"] = self.readings[f"change.{_label(CHANGE_QUANTILE)}"]
        return numbers

    def _read(self, name, program_runs, reference, ref_grad):
        """`readings[name.<quantile>]`: the leaf gap at each of READ_QUANTILES,
        the worse of the program's runs."""
        for label, q in READ_QUANTILES.items():
            self.readings[f"{name}.{label}"] = max(
                compare.leaf_gap(p, reference, ref_grad, q) for p in program_runs)

    def _look(self, patches, lens, start, direction, screen, target, extent, ref_grad):
        """The reference traced in float64 on the program's float32 tables:
        its step-1 gradient against the program's (the trace's share) and
        against the reference's (the build's share)."""
        from ..reference import tracer

        own = lens._replace(**{f: getattr(patches, f).to(torch.float64)
                               for f in ("control_points", "underlying", "dividers",
                                         "bary_inverse", "heights", "deriv_b")},
                            neighbours=patches.neighbours.long())
        _, g_cp, g_ri, trace = tracer.loss_and_grads(own, start, direction, screen, target,
                                                     extent)
        del trace
        mixed = compare.leaf_norms(g_cp, g_ri)
        program_grads = [compare.leaf_norms(*(run["grads"][k] for k in LEAVES))
                         for run in self.runs]
        for label, q in READ_QUANTILES.items():
            self.readings[f"look.trace.{label}"] = max(
                compare.leaf_gap(p, mixed, mixed, q) for p in program_grads)
            self.readings[f"look.build.{label}"] = compare.leaf_gap(mixed, ref_grad, ref_grad, q)


def _label(q: float) -> str:
    return next(k for k, v in READ_QUANTILES.items() if v == q)


def setup(cell, seed: int, device) -> State:
    return State(cell, seed, device)
