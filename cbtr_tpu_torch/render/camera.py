"""Ray-grid generation.

Counterpart of cbtr_tpu/render/camera.py.  Three host generators, NumPy as
there, so the same arguments give bit-identical rays:
* `angle_sweep_rays` -- the reference's refraction-test fan
  (reference/test.cpp:352-360): directions (sqrt(1-sinV^2-sinW^2), sinV, sinW).
* `ortho_ray_grid` -- parallel beam, the natural emitter for lens
  illumination simulation (collimated light), in the 16x8-pixel-block ray
  order the port's scenes trace.
* `pinhole_ray_grid` -- perspective camera for surface inspection renders.
All return (start [N,3], direction [N,3]) float32 NumPy arrays.

`OrthoGrid` describes an `ortho_ray_grid` and synthesizes its rays per index
in torch, on the device of the indices, bit-identical to the host grid.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import PI


def angle_sweep_rays(degrees_v: float, degrees_w: float, count_v: int, count_w: int):
    """Fan of rays from the origin (reference/test.cpp:352-360)."""
    v = np.arange(count_v, dtype=np.float32)
    w = np.arange(count_w, dtype=np.float32)
    sin_v = np.sin((v * degrees_v + 1.0) * PI / 180.0)
    sin_w = np.sin((w * degrees_w + 1.0) * PI / 180.0)
    sv, sw = np.meshgrid(sin_v, sin_w, indexing="ij")
    x = np.sqrt(np.maximum(1.0 - sv * sv - sw * sw, 0.0))
    d = np.stack([x, sv, sw], axis=-1).reshape(-1, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = np.zeros_like(d)
    return start, d


def grid_is_tileable(res_x: int, res_y: int) -> bool:
    """True when the grid admits the 16x8-pixel-block ray layout."""
    return res_x % 16 == 0 and res_y % 8 == 0


def grid_index_map(i, res_x: int, res_y: int, tiled: bool):
    """Flat ray index -> (ix, iy) pixel coordinates.

    tiled=True lays rays out so each 128-ray sweep tile covers a compact
    16x8 pixel block instead of a quarter-row strip: the tile's beam
    cross-section shrinks ~4x, so the per-tile bounding-volume cull skips
    more candidate blocks.  The bilinear splat is order-invariant, so no
    unsort is needed anywhere.  Pure integer arithmetic, for NumPy arrays
    and integer tensors alike."""
    if tiled:
        nby = res_y // 8
        t, w = i // 128, i % 128
        ix = (t // nby) * 16 + (w // 8)
        iy = (t % nby) * 8 + (w % 8)
        return ix, iy
    return i // res_y, i % res_y


def _beam_frame(center, direction, up):
    """(center, unit direction, right, v_up) as f32 NumPy vectors."""
    center = np.asarray(center, np.float32)
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float32)
    right = np.cross(d, up)
    right /= np.linalg.norm(right)
    v_up = np.cross(right, d)
    return center, d, right, v_up


def ortho_ray_grid(center, direction, up, width: float, height: float,
                   res_x: int, res_y: int, tiled: bool | None = None):
    """Parallel beam: res_x x res_y rays on a width x height rectangle
    centered at `center`, all travelling along `direction`.

    tiled=None (default) auto-selects the 16x8-block ray layout when the
    resolution admits it (see grid_index_map)."""
    if tiled is None:
        tiled = grid_is_tileable(res_x, res_y)
    center, d, right, v_up = _beam_frame(center, direction, up)

    i = np.arange(res_x * res_y)
    ix, iy = grid_index_map(i, res_x, res_y, tiled)
    gx = ((ix.astype(np.float32) + 0.5) / res_x - 0.5) * width
    gy = ((iy.astype(np.float32) + 0.5) / res_y - 0.5) * height
    start = (
        center[None]
        + gx[:, None] * right[None]
        + gy[:, None] * v_up[None]
    )
    dirs = np.broadcast_to(d, start.shape)
    return start.astype(np.float32), np.ascontiguousarray(dirs, np.float32)


class OrthoGrid(NamedTuple):
    """Device-side description of an `ortho_ray_grid`: rays are synthesized
    per index on the device instead of built on the host and uploaded (at
    4096x4096 the host arrays are 16.8M x 2 x 3 f32 = 403 MB a render), and
    a sharded render can synthesize only its own shard."""

    center: tuple      # (3,) floats
    direction: tuple   # (3,) unit beam direction
    up: tuple
    width: float
    height: float
    res_x: int
    res_y: int
    # 16x8-block ray layout.  None (default) resolves via grid_is_tileable,
    # the auto-selection of ortho_ray_grid(tiled=None), so an OrthoGrid and
    # the host grid of the same spec never desync; pass a bool only to force
    # a layout (it must then match the host grid's).
    tiled: bool | None = None

    @property
    def n_rays(self) -> int:
        return self.res_x * self.res_y

    def _tiled(self) -> bool:
        if self.tiled is None:
            return grid_is_tileable(self.res_x, self.res_y)
        return self.tiled

    def rays_at(self, idx):
        """(start [N,3], direction [N,3]) f32 on idx's device for flat grid
        indices idx [N] (an integer tensor), equal bit for bit to
        `ortho_ray_grid`'s rows idx: the frame is the host grid's, computed
        in NumPy, and the per-index part repeats the host grid's f32
        operations in its order, one torch op each (no op can be contracted
        into an FMA).  Every scalar operand is a tensor on the device: CUDA
        torch divides by a host scalar as a multiplication by its
        reciprocal."""
        dev = idx.device
        center, d, right, v_up = (torch.as_tensor(v, device=dev)
                                  for v in _beam_frame(self.center, self.direction, self.up))

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        ix, iy = grid_index_map(idx.to(torch.int64), self.res_x, self.res_y, self._tiled())
        half = f32(0.5)
        gx = ((ix.to(torch.float32) + half) / f32(self.res_x) - half) * f32(self.width)
        gy = ((iy.to(torch.float32) + half) / f32(self.res_y) - half) * f32(self.height)
        start = center[None] + gx[:, None] * right[None]
        start = start + gy[:, None] * v_up[None]
        return start, d.expand(start.shape).contiguous()


def pinhole_ray_grid(origin, look_at, up, fov_degrees: float, res_x: int, res_y: int):
    """Perspective camera ray grid."""
    origin = np.asarray(origin, np.float32)
    fwd = np.asarray(look_at, np.float32) - origin
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    v_up = np.cross(right, fwd)

    half = np.tan(fov_degrees * PI / 360.0)
    xs = ((np.arange(res_x, dtype=np.float32) + 0.5) / res_x * 2.0 - 1.0) * half
    ys = ((np.arange(res_y, dtype=np.float32) + 0.5) / res_y * 2.0 - 1.0) * half
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    d = (
        fwd[None, None]
        + gx[..., None] * right[None, None]
        + gy[..., None] * v_up[None, None]
    ).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = np.broadcast_to(origin, d.shape)
    return np.ascontiguousarray(start, np.float32), d.astype(np.float32)
