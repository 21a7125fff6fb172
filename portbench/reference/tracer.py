"""The plain reference of the lens trace, in float64.

The semantics are those of the reference's scalar tracer, which the port
keeps as `harness/reference_tracer.py` (reference/bezierTriangle.cpp:123-195,
bezierMesh.cpp:206-227, bezierLens.cpp:4-34): for every patch the candidate
with the barycentric gate on; a follow-side candidate is replaced by its
neighbour's with the gate off; the nearest cIntersect wins, the earliest
patch on ties.  Here the same arithmetic runs over (ray, patch) pairs in
plain torch ops, on whatever device the tensors are on.  Pass-1 pairs are
those of `work.pairs.candidate_pairs`, which drops no candidate (its
docstring says why); every retry is evaluated.

Then the refraction, the screen plane, the bilinear splat and the image loss
as the port's `render_lens_image` and `lens_loss` define them.  The winners
come from a pass without gradients; `trace` re-evaluates each ray's winner
with autograd on, so the gradients of the control points and the refractive
index are torch's autograd of the float64 arithmetic.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..work.pairs import candidate_pairs, patch_bounds
from . import geom
from .config import DEFAULT as CFG
from .patches import interpolate

W_FOLLOW0, W_FOLLOW1, W_FOLLOW2, W_NONE, W_INTERSECT = 0, 1, 2, 3, 4
R_NONE, R_INSIDE, R_OUTSIDE = 0, 1, 2

# pairs evaluated at once (bounds the working set of one batch)
_PAIR_BATCH = 1 << 22


class Lens(NamedTuple):
    """A lens as the reference traces it: the built tables (float64) and
    the parameters that a fit moves (control points, refractive index)."""

    control_points: torch.Tensor  # [P, 10, 3]
    neighbours: torch.Tensor      # [P, 3] int64
    underlying: torch.Tensor      # [P, 4]
    dividers: torch.Tensor        # [P, 3, 4]
    bary_inverse: torch.Tensor    # [P, 3, 3]
    heights: torch.Tensor         # [P, 2]
    deriv_b: torch.Tensor         # [P, 3]
    refractive_index: torch.Tensor


class Hit(NamedTuple):
    patch: torch.Tensor      # [R] int64, -1 where nothing was hit
    distance: torch.Tensor   # [R]
    point: torch.Tensor      # [R, 3]
    normal: torch.Tensor     # [R, 3]
    cos_incidence: torch.Tensor  # [R]


def _normal(cp, deriv_b, b):
    """The scalar tracer's `_normal`, over pairs."""
    b0, b1, b2 = b[:, 0:1], b[:, 1:2], b[:, 2:3]

    def c(k):
        return cp[:, k, :]

    c0 = (c(0) * (b0 * b0) + c(7) * (b2 * b2) + c(4) * (b1 * b1)
          + 2.0 * (c(8) * (b0 * b2) + c(3) * (b0 * b1) + c(9) * (b2 * b1)))
    c1 = (c(1) * (b1 * b1) + c(6) * (b2 * b2) + c(3) * (b0 * b0)
          + 2.0 * (c(9) * (b0 * b2) + c(4) * (b0 * b1) + c(5) * (b1 * b2)))
    c2 = (c(2) * (b2 * b2) + c(8) * (b0 * b0) + c(5) * (b1 * b1)
          + 2.0 * (c(7) * (b0 * b2) + c(6) * (b1 * b2) + c(9) * (b0 * b1)))
    ca = c0 - c2
    cb = deriv_b[:, 0:1] * c0 + deriv_b[:, 1:2] * c1 + deriv_b[:, 2:3] * c2
    n = geom.cross(ca, cb)
    ln = geom.norm(n)
    return n / torch.where(ln > 0.0, ln, 1.0)[:, None]


def _div(num, den, ok):
    """num / den where ok, 0 elsewhere, with no inf or NaN in either branch."""
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def evaluate(lens: Lens, q, s, d, limit_domain: bool):
    """The candidate of each pair (patch q[i], ray s[i] + t d[i]): the scalar
    tracer's `intersect_patch`, its early returns as a mask.  Returns (what,
    distance, point, normal, cos_incidence), what = W_NONE where it returned
    None."""
    cp = lens.control_points[q]
    n, c = lens.underlying[q, :3], lens.underlying[q, 3]
    binv = lens.bary_inverse[q]
    h_in, h_out = lens.heights[q, 0], lens.heights[q, 1]

    cos_inc = geom.dot(d, n)
    valid = cos_inc.abs() >= CFG.ray_plane_intersection_epsilon
    cos_safe = torch.where(valid, cos_inc, 1.0)
    dist0 = (c - geom.dot(n, s)) / cos_safe
    valid = valid & (dist0 > 0.0) & (dist0.abs() > -h_in) & (dist0.abs() > h_out)
    if limit_domain:
        bary0 = geom.apply_mat3(binv, s + dist0[:, None] * d)
        valid = valid & ((bary0 >= 0.0) & (bary0 <= 1.0)).all(dim=-1)

    d_in, d_out = h_in / cos_safe, h_out / cos_safe
    going = cos_safe > 0.0
    closer = dist0 + torch.where(going, d_in, d_out)
    further = dist0 + torch.where(going, d_out, d_in)

    def surf_diff(t):
        p = s + t[:, None] * d
        pd = geom.dot(p, n) - c
        b = geom.apply_mat3(binv, p - n * pd[:, None])
        return pd.abs() - (geom.dot(interpolate(cp, b), n) - c).abs()

    diff_c, diff_f = surf_diff(closer), surf_diff(further)
    denom = diff_c - diff_f
    small = denom.abs() < CFG.intersection_estimation_epsilon
    middle = torch.where(small, (closer + further) / 2.0,
                         (diff_c * further - diff_f * closer) / torch.where(small, 1.0, denom))
    if CFG.clamp_secant_estimate:
        middle = torch.minimum(torch.maximum(middle, torch.minimum(closer, further)),
                               torch.maximum(closer, further))

    proj_dir = n
    distance = middle
    for _ in range(CFG.root_search_iterations):
        distance = middle
        p = s + middle[:, None] * d
        dd = geom.dot(proj_dir, n)
        t = _div(c - geom.dot(n, p), dd, dd.abs() > 1e-12)
        plane_pt = p + t[:, None] * proj_dir
        bary = geom.apply_mat3(binv, plane_pt)
        normal = _normal(cp, lens.deriv_b[q], bary)
        surf_pt = interpolate(cp, bary)
        step = surf_pt - plane_pt
        ln = geom.norm(step)
        moved = ln > 0.0
        proj_dir = torch.where(moved[:, None], step / torch.where(moved, ln, 1.0)[:, None],
                               proj_dir)
        dn = geom.dot(d, normal)
        ok = dn.abs() > 1e-12
        middle = torch.where(ok, _div(geom.dot(surf_pt - s, normal), dn, ok), middle)

    rel = surf_pt - s
    ray_dist = geom.norm(rel - geom.dot(rel, d)[:, None] * d)
    valid = valid & (ray_dist <= CFG.max_intersection_distance_from_ray)
    valid = valid & (distance >= (further - closer) * CFG.minimal_ray_distance)

    div = lens.dividers[q]
    d_div = geom.dot(div[:, :, :3], surf_pt[:, None, :]) - div[:, :, 3]
    outside = ((d_div[:, 0] < 0.0).long() + 2 * (d_div[:, 1] < 0.0).long()
               + 4 * (d_div[:, 2] < 0.0).long())
    what = torch.full_like(outside, W_INTERSECT)
    what = torch.where(outside == 1, W_FOLLOW0, what)
    what = torch.where(outside == 2, W_FOLLOW1, what)
    what = torch.where(outside == 4, W_FOLLOW2, what)
    what = torch.where(valid, what, W_NONE)
    return what, distance, surf_pt, normal, geom.dot(d, normal)


def _batched(q, s, d, lens, limit_domain):
    """`evaluate` in batches of _PAIR_BATCH pairs, without gradients:
    (what, distance)."""
    whats, dists = [], []
    for i in range(0, q.shape[0], _PAIR_BATCH):
        w, dist, _, _, _ = evaluate(lens, q[i:i + _PAIR_BATCH], s[i:i + _PAIR_BATCH],
                                    d[i:i + _PAIR_BATCH], limit_domain)
        whats.append(w)
        dists.append(dist)
    if not whats:
        return q.new_zeros(0), s.new_zeros(0)
    return torch.cat(whats), torch.cat(dists)


def winners(lens: Lens, start, direction):
    """(patch [R] int64, -1 for a miss; distance [R]) of every ray: the
    nearest cIntersect over every patch, a follow-side result replaced by the
    neighbour's gate-off candidate, the earliest patch slot on ties."""
    R = start.shape[0]
    with torch.no_grad():
        cp = lens.control_points.detach()
        r, slot = candidate_pairs(patch_bounds(cp), start, direction)
        what, dist = _batched(slot, start[r], direction[r], lens, True)
        follow = what < W_NONE
        q = torch.where(follow, lens.neighbours[slot, what.clamp(0, 2)], slot)
        fr = follow.nonzero(as_tuple=True)[0]
        w2, d2 = _batched(q[fr], start[r[fr]], direction[r[fr]], lens, False)
        what = what.clone()
        dist = dist.clone()
        what[fr] = w2
        dist[fr] = d2
        hit = what == W_INTERSECT
        r, slot, q, dist = r[hit], slot[hit], q[hit], dist[hit]
        best = torch.full((R,), float("inf"), dtype=dist.dtype, device=dist.device)
        best = best.scatter_reduce(0, r, dist, "amin")
        at_best = dist == best[r]
        P = lens.control_points.shape[0]
        first = torch.full((R,), P, dtype=torch.long, device=dist.device)
        first = first.scatter_reduce(0, r[at_best], slot[at_best], "amin")
        chosen = at_best & (slot == first[r])
        patch = torch.full((R,), -1, dtype=torch.long, device=dist.device)
        patch[r[chosen]] = q[chosen]
        distance = torch.where(patch >= 0, best, torch.zeros_like(best))
    return patch, distance


def intersect(lens: Lens, start, direction) -> Hit:
    """Each ray's winner (`winners`) and its candidate's fields, evaluated
    again on the winning patch with autograd on (a retry's winner is its
    gate-off candidate, a direct one the same candidate with the gate's mask
    left out)."""
    patch, _ = winners(lens, start, direction)
    hit = (patch >= 0).nonzero(as_tuple=True)[0]
    R = start.shape[0]
    what, dist, point, normal, cos = evaluate(lens, patch[hit], start[hit], direction[hit],
                                              False)
    zeros = start.new_zeros(R)
    return Hit(
        patch=patch,
        distance=zeros.index_put((hit,), dist),
        point=start.index_put((hit,), point),
        normal=start.new_zeros(R, 3).index_put((hit,), normal),
        cos_incidence=zeros.index_put((hit,), cos),
    )


def refract(lens: Lens, start, direction, expected: int):
    """(new_start, new_direction, status, hit) of the scalar tracer's
    `refract`, over a batch: a ray whose status is R_NONE carries its input."""
    hit = intersect(lens, start, direction)
    ok = hit.patch >= 0
    cos_inc = hit.cos_incidence
    going_in = cos_inc < 0.0
    status = torch.where(going_in, R_INSIDE, R_OUTSIDE)
    ri = lens.refractive_index
    eff = torch.where(going_in, 1.0 / ri, ri)
    sin2 = eff * eff * (1.0 - cos_inc * cos_inc)
    tir = sin2 >= CFG.max_sin2_refraction
    bends = sin2 > CFG.min_sin2_refraction
    normal = hit.normal * torch.where(going_in, 1.0, -1.0)[:, None]
    cos2 = torch.sqrt(torch.where(tir, 0.5, 1.0 - sin2))
    bent = direction * eff[:, None] + normal * (eff * cos_inc.abs() - cos2)[:, None]
    bent = bent / geom.norm(bent)[:, None]
    new_dir = torch.where(bends[:, None], bent, direction)
    status = torch.where(ok & ~tir & (status == expected), status, R_NONE)
    alive = (status != R_NONE)[:, None]
    return (torch.where(alive, hit.point, start), torch.where(alive, new_dir, direction),
            status, hit)


def screen_hits(start, direction, screen_plane):
    """(hit2d [R,2], valid [R]) on the screen plane, in the frame of the
    port's `render.screen_hits` (u = a_perpendicular(normal), v = n x u)."""
    n = geom.plane_normal(screen_plane)
    u = geom.a_perpendicular(n)
    v = geom.cross(n, u)
    cos = geom.dot(direction, n)
    ok = cos.abs() >= CFG.ray_plane_intersection_epsilon
    t = _div(geom.plane_constant(screen_plane) - geom.dot(n, start), cos, ok)
    valid = ok & (t > 0.0)
    point = start + t[:, None] * direction
    return torch.stack([geom.dot(point, u), geom.dot(point, v)], dim=-1), valid


def splat(points2d, weights, extent: float, res: int):
    """[res, res] image: each point's weight spread bilinearly over the four
    pixels around it (x along rows, y along columns), pixels off the image
    dropped."""
    xy = (points2d / (2.0 * extent) + 0.5) * res - 0.5
    x0 = torch.floor(xy)
    frac = xy - x0
    i0 = x0.clamp(-2.0, float(res)).long()
    img = points2d.new_zeros(res * res)
    for dx in (0, 1):
        for dy in (0, 1):
            wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            ix, iy = i0[:, 0] + dx, i0[:, 1] + dy
            inside = (ix >= 0) & (ix < res) & (iy >= 0) & (iy < res)
            img = img.index_add(0, torch.where(inside, ix * res + iy, 0),
                                torch.where(inside, weights * wx * wy, 0.0))
    return img.reshape(res, res)


class Trace(NamedTuple):
    """One trace through the lens: each pass's winners and hit distances and
    the rays it leaves, and the image."""

    patch1: torch.Tensor
    distance1: torch.Tensor
    start1: torch.Tensor
    direction1: torch.Tensor
    status1: torch.Tensor
    patch2: torch.Tensor
    distance2: torch.Tensor
    start2: torch.Tensor
    direction2: torch.Tensor
    status2: torch.Tensor
    image: torch.Tensor


def trace(lens: Lens, start, direction, screen_plane, extent: float, res: int) -> Trace:
    """Entry and exit refraction, the screen, the splat: the port's
    `render_lens_image` for one batch of rays."""
    s1, d1, st1, h1 = refract(lens, start, direction, R_INSIDE)
    s2, d2, st2, h2 = refract(lens, s1, d1, R_OUTSIDE)
    hit2d, on_screen = screen_hits(s2, d2, screen_plane)
    live = (st1 == R_INSIDE) & (st2 == R_OUTSIDE) & on_screen
    hit2d = torch.where(live[:, None], hit2d, 0.0)
    image = splat(hit2d, live.to(hit2d.dtype), extent, res)
    return Trace(h1.patch, h1.distance, s1, d1, st1, h2.patch, h2.distance, s2, d2, st2, image)


def render(lens: Lens, start, direction, screen_plane, extent: float, res: int,
           chunk: int = 1 << 20, keep_rays: bool = True):
    """`trace` without gradients over rays in chunks, the images summed.
    Returns the image and, with keep_rays, each pass's per-ray fields as in
    `Trace` (else None)."""
    image = None
    parts = []
    with torch.no_grad():
        for r0 in range(0, start.shape[0], chunk):
            t = trace(lens, start[r0:r0 + chunk], direction[r0:r0 + chunk], screen_plane,
                      extent, res)
            image = t.image if image is None else image + t.image
            if keep_rays:
                parts.append(t[:-1])
    if not keep_rays:
        return image, None
    fields = [torch.cat(f) for f in zip(*parts)]
    return image, Trace(*fields, image)


def loss_and_grads(lens: Lens, start, direction, screen_plane, target, extent: float):
    """(loss, d loss / d control points, d loss / d refractive index, trace)
    of the port's `lens_loss`: the mean squared gap between the image and
    `target`, by autograd through `trace`."""
    cp = lens.control_points.detach().requires_grad_(True)
    ri = lens.refractive_index.detach().requires_grad_(True)
    live = lens._replace(control_points=cp, refractive_index=ri)
    t = trace(live, start, direction, screen_plane, extent, target.shape[0])
    loss = torch.mean((t.image - target) ** 2)
    g_cp, g_ri = torch.autograd.grad(loss, (cp, ri))
    detached = Trace(*(x.detach() for x in t))
    return loss.detach(), g_cp, g_ri, detached
