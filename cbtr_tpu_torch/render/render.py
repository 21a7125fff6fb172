"""Differentiable image formation.

Counterpart of cbtr_tpu/render/render.py: rays refract through the lens
(reference/test.cpp:330-427 state machine), land on a screen plane and are
splatted bilinearly into an irradiance image.  The splat keeps the whole
pipeline differentiable: d(image)/d(control points, refractive index, ray
origins) flows through the hit positions.

Also the point-source renders (host-sampled and device-made emitter rays)
and the surface-inspection render, `render_surface_normals`.

The outer-product splat is one plain f32 matrix product (`torch.matmul`, as
the JAX package left it to XLA); the callers on the GPU keep TF32 off so the
product runs in full f32.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import geom
from ..ops.cuda_segment import segment_sum
from ..ops.intersect import WHAT_INTERSECT, intersect_rays
from ..optics.lens import trace_through_lens
from ..utils.profiling import backward_span, span
from . import emitters


@span("cbtr.screen_hits")
@backward_span("cbtr.backward.screen_hits")
def screen_hits(start, direction, screen_plane):
    """Intersect rays with the screen plane; returns (hit2d [N,2], valid).

    The screen's 2D frame is (u, v) = the two in-plane axes of the
    `geom.a_perpendicular` construction."""
    n = geom.plane_normal(screen_plane)
    u = geom.a_perpendicular(n)
    v = geom.cross(n, u)
    valid, point, _, _ = geom.plane_ray_intersect(screen_plane, start, direction)
    hit2d = torch.stack([geom.dot(point, u), geom.dot(point, v)], dim=-1)
    return hit2d, valid


# Use the outer-product splat while the two [N, res] axis-weight matrices fit
# comfortably in device memory; above that add into the pixels by segment sum.
_SPLAT_MATMUL_MAX_BYTES = 1_200_000_000


def _floor_index(coord, res: int):
    """(floor(coord) as i64, the fractional part).  The index is clamped to
    [-2, res] before the cast: a live ray far off screen has a coordinate
    beyond int range, whose cast is undefined.  Pixels floor and floor+1
    both lie outside [0, res) for any floor outside [-1, res-1], so the
    clamp changes no in-image result."""
    x0 = torch.floor(coord)
    return x0.clamp(-2.0, float(res)).to(torch.int64), coord - x0


def _splat_axis_weights(coord, res: int):
    """Bilinear weights of one axis as a dense [N, res] matrix: row r has
    (1-frac) at floor(coord_r) and frac at floor+1 (out-of-range columns
    never match — the same drop semantics as the scatter path)."""
    x0i, frac = _floor_index(coord, res)
    iota = torch.arange(res, device=coord.device)[None, :]
    x0i = x0i[:, None]
    return (torch.where(iota == x0i, 1.0 - frac[:, None], 0.0)
            + torch.where(iota == x0i + 1, frac[:, None], 0.0))


@span("cbtr.splat")
@backward_span("cbtr.backward.splat")
def splat_bilinear(points2d, weights, extent, resolution: int):
    """Accumulate points into a [res, res] image with bilinear footprints.

    points2d [N,2] in [-extent, extent]^2; weights [N] (0 kills a point).
    Differentiable w.r.t. points2d and weights.

    Two formulations with identical math (f32-rounding-level agreement):

    * outer product (default): the footprint is separable,
      img[i,j] = sum_r w_r * wx_r[i] * wy_r[j], i.e. one [res,N] @ [N,res]
      product of per-axis weight matrices; its transpose is again a product;
    * a fixed-order segment sum (`ops.cuda_segment.segment_sum`, the
      scatter-add of the JAX package) when the [N, res] weight matrices
      would exceed ~1.2 GB.
    """
    res = resolution
    xy = (points2d / (2.0 * extent) + 0.5) * res - 0.5
    n = points2d.shape[0]

    if 2 * 4 * n * res <= _SPLAT_MATMUL_MAX_BYTES:
        ax = _splat_axis_weights(xy[:, 0], res) * weights[:, None]
        ay = _splat_axis_weights(xy[:, 1], res)
        return ax.T @ ay

    # the four passes' contributions, pass by pass (00, 01, 10, 11) and point
    # by point, summed into the pixels in that order by one fixed-order
    # segment sum (on the CPU the left fold of four sequential index_adds)
    x0i, frac = _floor_index(xy, res)
    pixels, contributions = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            ix = x0i[:, 0] + dx
            iy = x0i[:, 1] + dy
            inside = (ix >= 0) & (ix < res) & (iy >= 0) & (iy < res)
            contributions.append(torch.where(inside, weights * wx * wy, 0.0))
            pixels.append((ix.clamp(0, res - 1) * res + iy.clamp(0, res - 1))
                          .to(torch.int32))
    # the per-pass tensors go before the sort (at 16.8 M rays, 0.5 GB)
    pixels, contributions = torch.cat(pixels), torch.cat(contributions)[:, None]
    return segment_sum(pixels, contributions, res * res).reshape(res, res)


@span("cbtr.render")
def render_lens_image(patches, refractive_index, start, direction, screen_plane,
                      extent: float = 4.0, resolution: int = 128,
                      chunk_size: int = 0, weights=None, backend: str = "auto",
                      intersect_fn=None):
    """Flagship forward model: collimated rays -> lens entry/exit refraction
    -> screen splat -> [res, res] irradiance image.

    weights: optional per-ray multiplier [...]; 0 removes a ray from the
    image.  backend: see ops.intersect.intersect_rays; intersect_fn: see
    optics.lens.refract_rays."""
    out_s, out_d, alive, _, _ = trace_through_lens(
        patches, refractive_index, start, direction, chunk_size=chunk_size,
        backend=backend, intersect_fn=intersect_fn,
    )
    hit2d, on_screen = screen_hits(out_s, out_d, screen_plane)
    live = alive & on_screen
    w = live.to(torch.float32)
    if weights is not None:
        w = w * weights.to(torch.float32)
    # dead rays keep finite positions; weight 0 removes them from the image
    hit2d = torch.where(live[..., None], hit2d, 0.0)
    return splat_bilinear(hit2d.reshape(-1, 2), w.reshape(-1), extent, resolution)


def render_emitter_image(patches, refractive_index, emitter, n_rays: int,
                         origin, screen_plane, extent: float = 4.0,
                         resolution: int = 128, chunk_size: int = 0):
    """Point-source render: hemisphere-emitter rays -> lens -> screen image.

    The emitter's belt/patch bin (reference/hostUtil.cpp:9-13, designed
    there for GPU warp coherence) is the ray sort key: rays are ordered by
    bin before tracing so each 128-ray sweep tile sees spatially coherent
    directions and the kernels' cull can skip blocks.  The bilinear splat is
    order-invariant, so no unsort pass is needed.

    emitter: UniformHemisphere (host-side sampling + binning); the rays are
    uploaded to the device of `patches`.
    origin: [3] emitter position; rays head into the +x hemisphere."""
    d, patch = emitter.sample(n_rays)
    order = np.argsort(patch, kind="stable")
    dev = patches.device
    d = torch.as_tensor(d[order], device=dev)
    s = torch.as_tensor(np.asarray(origin, np.float32), device=dev).expand(d.shape)
    return render_lens_image(
        patches, refractive_index, s, d, screen_plane, extent=extent,
        resolution=resolution, chunk_size=chunk_size,
    )


def render_emitter_image_device(patches, refractive_index, emitter,
                                screen_plane, extent: float = 4.0,
                                resolution: int = 128, chunk_size: int = 0):
    """Point-source render with rays synthesized on the device of `patches`,
    pre-sorted by the belt/patch bin (emitters.DeviceEmitter): no host
    sampling, no host argsort, no ray upload.  The per-ray unbiasing
    weights ride the splat's weight input."""
    idx = torch.arange(emitter.n_rays, dtype=torch.int64, device=patches.device)
    s, d, w = emitters.synthesize(emitter, idx)
    return render_lens_image(
        patches, refractive_index, s, d, screen_plane, extent=extent,
        resolution=resolution, chunk_size=chunk_size, weights=w,
    )


def render_surface_normals(patches, start, direction, light_dir,
                           chunk_size: int = 0, backend: str = "auto"):
    """Surface-inspection render: first-hit Lambertian shading + depth.

    Returns (shade [N], depth [N], hit_mask [N]) for a ray batch; the
    replacement for the reference's Blender STL inspection loop."""
    hit = intersect_rays(patches, start, direction, chunk_size=chunk_size,
                         backend=backend)
    ok = hit.what == WHAT_INTERSECT
    light = geom.safe_normalize(torch.as_tensor(light_dir, dtype=torch.float32,
                                                device=hit.normal.device))
    shade = torch.clamp(-geom.dot(hit.normal, light), 0.0, 1.0)
    shade = torch.where(ok, shade, 0.0)
    depth = torch.where(ok, hit.distance, 0.0)
    return shade, depth, ok
