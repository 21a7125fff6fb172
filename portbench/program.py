"""The benchmark's calls into the port (`cbtr_tpu_torch`), made only from
inside the functions here and in the drivers: importing this module loads
nothing of the port."""
from __future__ import annotations

import contextlib

# the spans of a traced unit: (label, module, attribute), each a call into
# one of the port's layers, from the trace down to the kernels' callers
SPANS = (
    ("trace_through_lens", "cbtr_tpu_torch.render.render", "trace_through_lens"),
    ("tables", "cbtr_tpu_torch.optics.lens", "winner_tables"),
    ("refract_rays", "cbtr_tpu_torch.optics.lens", "refract_rays"),
    ("intersect_rays", "cbtr_tpu_torch.optics.lens", "intersect_rays"),
    ("winner_search", "cbtr_tpu_torch.ops.intersect", "_winner_chunk"),
    ("recompute_winner", "cbtr_tpu_torch.ops.intersect", "recompute_winner"),
    ("screen_hits", "cbtr_tpu_torch.render.render", "screen_hits"),
    ("splat_bilinear", "cbtr_tpu_torch.render.render", "splat_bilinear"),
    ("backward", "torch.autograd", "backward"),
)


def lens_scene(cell, mesh_path: str, device):
    """The configuration's lens, built by the port from the benchmark's copy
    of the mesh (`models/scenes.py::robot_lens_scene`; res=1: the scene's own
    ray grid is not used)."""
    from cbtr_tpu_torch.models import robot_lens_scene

    cfg = cell.config
    return robot_lens_scene(res=1, refractive_index=float(cfg["refractive_index"]),
                            path=mesh_path, refine=bool(cfg["refine"]), device=device)


@contextlib.contextmanager
def capture_passes():
    """While on, each refraction pass of the port (`optics.lens.refract_rays`
    with its `intersect_rays`) appends to the yielded list a dict of detached
    copies of its winners, hit distances and the rays it leaves."""
    from cbtr_tpu_torch.optics import lens

    passes, hits = [], []
    refract, intersect = lens.refract_rays, lens.intersect_rays

    def intersect_kept(*args, **kwargs):
        hit = intersect(*args, **kwargs)
        hits.append(hit)
        return hit

    def refract_kept(*args, **kwargs):
        s, d, status = refract(*args, **kwargs)
        hit = hits.pop()
        passes.append({"patch": hit.patch.detach().clone(),
                       "distance": hit.distance.detach().clone(),
                       "start": s.detach().clone(), "direction": d.detach().clone(),
                       "status": status.detach().clone()})
        return s, d, status

    lens.intersect_rays, lens.refract_rays = intersect_kept, refract_kept
    try:
        yield passes
    finally:
        lens.intersect_rays, lens.refract_rays = intersect, refract


def reference_passes(trace) -> list:
    """A reference `Trace`'s two passes as `capture_passes` gives the
    program's."""
    return [{"patch": trace.patch1, "distance": trace.distance1, "start": trace.start1,
             "direction": trace.direction1, "status": trace.status1},
            {"patch": trace.patch2, "distance": trace.distance2, "start": trace.start2,
             "direction": trace.direction2, "status": trace.status2}]
