"""The (ray, patch) pairs that the port's per-pair candidate test passes.

A frozen copy of the port's cull arithmetic (`ops/cuda_sweep.py`:
`patch_spheres`, `_patch_boxes`, `sphere_hit_pairs`, `_ray_aabb_hit`) with
its constants, so that the roofline's yardstick stays where it is whatever a
later change does to the kernels' own cull: a pair counts when the ray hits
the patch's bounding sphere (the control net's, inflated by SPHERE_INFLATION)
and its AABB (the control net's box widened by the sphere's slack).

The plain reference tracer uses the same test as its pass-1 filter: a pass-1
candidate needs the ray to cross the patch's flat triangle, whose corners are
control points, so the ray meets the net's hull and with it the inflated
sphere and the widened box; the filter drops no candidate.
"""
from __future__ import annotations

import torch

# the port's constants (ops/cuda_sweep.py `patch_spheres`), frozen
SPHERE_INFLATION = 1.25
SPHERE_PAD = 1e-5
# pairs of the dense sphere test held at once (rays x patches)
_DENSE_PAIRS = 1 << 26


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def patch_bounds(control_points):
    """(center [P,3], radius [P], lo [P,3], hi [P,3]) of each patch's control
    net [P,10,3]: the inflated bounding sphere and the widened AABB."""
    cp = control_points
    center = cp.sum(dim=1) / 10.0
    r_hull = _norm3(cp - center[:, None, :]).amax(dim=-1)
    radius = r_hull * SPHERE_INFLATION + SPHERE_PAD
    slack = (radius - r_hull).clamp_min(0.0)[:, None]
    return center, radius, cp.amin(dim=1) - slack, cp.amax(dim=1) + slack


BLOCK = 16                  # patches a block of the prefilter


def _sphere_hits(center, radius, s, d):
    """[R, P] bool: the half-line s + t d (t >= 0) meets the sphere."""
    # the port's expression over rel = center - s, expanded into products
    # (exact enough in float64, in which the harness runs it)
    t_ca = d @ center.T - (s * d).sum(-1)[:, None]
    rel2 = ((center * center).sum(-1)[None, :] - 2.0 * (s @ center.T)
            + (s * s).sum(-1)[:, None])
    r2 = (radius * radius)[None, :]
    return ((rel2 - t_ca * t_ca) <= r2) & ((t_ca >= 0.0) | (rel2 <= r2))


def _pair_sphere_hits(center, radius, s, d):
    """[N] bool: each pair's half-line meets its sphere (the same test)."""
    rel = center - s
    t_ca = (rel * d).sum(-1)
    rel2 = (rel * rel).sum(-1)
    r2 = radius * radius
    return ((rel2 - t_ca * t_ca) <= r2) & ((t_ca >= 0.0) | (rel2 <= r2))


def _box_hits(lo, hi, s, d):
    """[N] bool: each pair's half-line s + t d meets its box [lo, hi]."""
    d_safe = torch.where(d.abs() < 1e-30, torch.where(d < 0.0, -1e-30, 1e-30), d)
    inv = 1.0 / d_safe
    t1 = (lo - s) * inv
    t2 = (hi - s) * inv
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    return (tmax >= 0.0) & (tmin <= tmax)


def _blocks(center, radius):
    """Spheres over runs of BLOCK patches, each holding its patches' spheres
    (a prefilter that drops no pair)."""
    P = center.shape[0]
    pad = (-P) % BLOCK
    c = torch.cat([center, center[-1:].expand(pad, 3)]).reshape(-1, BLOCK, 3)
    r = torch.cat([radius, radius[-1:].expand(pad)]).reshape(-1, BLOCK)
    bc = c.mean(dim=1)
    return bc, (_norm3(c - bc[:, None, :]) + r).amax(dim=1)


def candidate_pairs(bounds, start, direction):
    """(ray ids [N], patch ids [N]), int64, of the pairs that pass the test,
    ray-major.  bounds: `patch_bounds`; start, direction [R,3] in the
    bounds' type, float64 for the expanded sphere test to hold."""
    center, radius, lo, hi = bounds
    P = center.shape[0]
    bc, br = _blocks(center, radius)
    chunk = max(1, _DENSE_PAIRS // max(bc.shape[0], 1))
    within = torch.arange(BLOCK, device=center.device)
    rays, patches = [], []
    for r0 in range(0, start.shape[0], chunk):
        s, d = start[r0:r0 + chunk], direction[r0:r0 + chunk]
        r, b = torch.nonzero(_sphere_hits(bc, br, s, d), as_tuple=True)
        p = (b[:, None] * BLOCK + within[None, :]).reshape(-1)
        r = r.repeat_interleave(BLOCK)
        real = p < P
        r, p = r[real], p[real]
        keep = _pair_sphere_hits(center[p], radius[p], s[r], d[r])
        r, p = r[keep], p[keep]
        keep = _box_hits(lo[p], hi[p], s[r], d[r])
        r, p = r[keep], p[keep]
        rays.append(r + r0)
        patches.append(p)
    return torch.cat(rays), torch.cat(patches)


def count_pairs(bounds, start, direction) -> int:
    """The number of pairs `candidate_pairs` gives."""
    return int(candidate_pairs(bounds, start, direction)[0].shape[0])
