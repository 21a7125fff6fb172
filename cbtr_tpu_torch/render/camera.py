"""Ray-grid generation (host-side NumPy).

Counterpart of cbtr_tpu/render/camera.py's collimated-beam generator,
`ortho_ray_grid`, with the same 16x8-pixel-block ray order, so the port's
scenes trace bit-identical rays.  Returns (start [N,3], direction [N,3])
float32 NumPy arrays.
"""
from __future__ import annotations

import numpy as np


def grid_is_tileable(res_x: int, res_y: int) -> bool:
    """True when the grid admits the 16x8-pixel-block ray layout."""
    return res_x % 16 == 0 and res_y % 8 == 0


def grid_index_map(i, res_x: int, res_y: int, tiled: bool):
    """Flat ray index -> (ix, iy) pixel coordinates.

    tiled=True lays rays out so each 128-ray sweep tile covers a compact
    16x8 pixel block instead of a quarter-row strip: the tile's beam
    cross-section shrinks ~4x, so the per-tile bounding-volume cull skips
    more candidate blocks.  The bilinear splat is order-invariant, so no
    unsort is needed anywhere."""
    if tiled:
        nby = res_y // 8
        t, w = i // 128, i % 128
        ix = (t // nby) * 16 + (w // 8)
        iy = (t % nby) * 8 + (w % 8)
        return ix, iy
    return i // res_y, i % res_y


def ortho_ray_grid(center, direction, up, width: float, height: float,
                   res_x: int, res_y: int, tiled: bool | None = None):
    """Parallel beam: res_x x res_y rays on a width x height rectangle
    centered at `center`, all travelling along `direction`.

    tiled=None (default) auto-selects the 16x8-block ray layout when the
    resolution admits it (see grid_index_map)."""
    if tiled is None:
        tiled = grid_is_tileable(res_x, res_y)
    center = np.asarray(center, np.float32)
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float32)
    right = np.cross(d, up)
    right /= np.linalg.norm(right)
    v_up = np.cross(right, d)

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
