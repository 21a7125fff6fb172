"""Mesh-vertex lens design: optimize the lens SHAPE end to end.

Counterpart of cbtr_tpu/models/design.py.  The free parameters are the
welded mesh vertices [V,3] (and the refractive index); every step rebuilds
the whole Clough-Tocher patch set from them with `bezier.build_patches`
(plain torch ops, so the gradient flows through control-point
construction, divider planes and height sampling), so the derived tables
stay exact at every iterate -- unlike `lens_model.LensParams`, whose tables
stay those of the initial control net (the car-lamp scenario,
reference/README.md:159-165).

The corner-average normals (mesh.cpp:284-308's angle-weighted vertex
normals) are rebuilt differentiably each step.  The JAX package sums each
vertex's corner contributions with `jax.ops.segment_sum`; here each vertex
gathers its corners through a [V, K] table built on the host (ascending,
padded) and adds them in that order.  On the card `index_add_` would add
with atomics, so its sums, and every patch table built from them, would
change in their last bits between calls; the gather and the in-order sum
do not, and since each corner occurs once in the table the gather's
backward has no colliding writes.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .. import geom
from ..bezier.build import build_patches
from ..render.render import render_lens_image


class DesignTopology(NamedTuple):
    """Static (non-differentiated) connectivity of the design mesh, int64."""

    face2vertex: torch.Tensor     # [F,3] welded vertex id per corner
    fellow: torch.Tensor          # [F,3] (TriMesh.fellow_triangles)
    fellow_starts: torch.Tensor   # [F,3]
    vertex_corners: torch.Tensor  # [V,K] flat corner ids (3f + i) of each
    #                               vertex, ascending, padded with 3F


class DesignParams(nn.Module):
    """The design variables: `vertices` [V,3] and `refractive_index`."""

    def __init__(self, vertices, refractive_index):
        super().__init__()
        v = torch.as_tensor(vertices, dtype=torch.float32)
        self.vertices = nn.Parameter(v.detach().clone())
        self.refractive_index = nn.Parameter(torch.as_tensor(
            refractive_index, dtype=torch.float32, device=v.device).detach().clone())


def vertex_corner_table(face2vertex: np.ndarray, num_vertices: int) -> np.ndarray:
    """[V, K] int64: row v lists the flat corner ids c (face c // 3, corner
    c % 3) with face2vertex.flat[c] == v in ascending order, then 3F."""
    flat = np.asarray(face2vertex, np.int64).reshape(-1)
    order = np.argsort(flat, kind="stable")          # corners grouped by vertex
    counts = np.bincount(flat, minlength=num_vertices)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(flat.size) - starts[flat[order]]
    table = np.full((num_vertices, int(counts.max())), flat.size, np.int64)
    table[flat[order], slot] = order
    return table


def topology_from_mesh(mesh, device="cuda") -> tuple[DesignTopology, DesignParams]:
    """(static topology, initial params) of a preprocessed TriMesh, on
    `device`.

    face2vertex is rebuilt from the welded coordinates with np.unique (exact
    equality after welding), as in the JAX package."""
    tris = np.asarray(mesh.tris, np.float32)
    verts, inverse = np.unique(tris.reshape(-1, 3), axis=0, return_inverse=True)
    face2vertex = inverse.reshape(-1, 3).astype(np.int64)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    topo = DesignTopology(
        face2vertex=t(face2vertex),
        fellow=t(mesh.fellow_triangles),
        fellow_starts=t(mesh.fellow_common_side_starts),
        vertex_corners=t(vertex_corner_table(face2vertex, verts.shape[0])),
    )
    return topo, DesignParams(torch.as_tensor(verts, device=device), 1.3)


def corner_average_normals(tris, face2vertex, vertex_corners):
    """Differentiable angle-weighted vertex-average normals per corner
    [F,3,3] (mesh.cpp:284-308; the JAX package's function, with the
    segment sum over `vertex_corners` in ascending corner order)."""
    normals = geom.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    unit = normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True).clamp_min(1e-30)
    side_a = torch.roll(tris, -1, dims=1) - tris
    side_b = torch.roll(tris, -2, dims=1) - tris
    cosang = torch.sum(side_a * side_b, dim=-1) / (
        torch.linalg.vector_norm(side_a, dim=-1)
        * torch.linalg.vector_norm(side_b, dim=-1)).clamp_min(1e-30)
    # the reference's arccos(clip): its gradient is infinite at +-1, which
    # only a degenerate corner reaches
    angle = torch.arccos(cosang.clamp(-1.0, 1.0))                 # [F,3]
    contrib = (unit[:, None, :] * angle[..., None]).reshape(-1, 3)
    contrib = torch.cat([contrib, contrib.new_zeros(1, 3)])       # row 3F: padding
    rows = contrib[vertex_corners]                                # [V,K,3]
    sums = rows[:, 0]
    for k in range(1, rows.shape[1]):
        sums = sums + rows[:, k]
    sums = sums / torch.linalg.vector_norm(sums, dim=-1, keepdim=True).clamp_min(1e-30)
    return sums[face2vertex]                                      # [F,3,3]


def patches_from_vertices(params: DesignParams, topo: DesignTopology):
    """Vertices -> the full Clough-Tocher patch set, differentiably."""
    tris = params.vertices[topo.face2vertex]                      # [F,3,3]
    navg = corner_average_normals(tris, topo.face2vertex, topo.vertex_corners)
    return build_patches(tris, topo.fellow, topo.fellow_starts, navg)


def design_loss(params: DesignParams, topo: DesignTopology, start, direction,
                screen_plane, target, resolution: int = 64,
                extent: float = 4.0, flux_weight: float = 0.1):
    """Pattern + flux loss for a design iterate: (loss, img).

    Pattern term: MSE between the flux-normalized image and the normalized
    target, the shape of the illumination whatever light survives.  Flux
    term: (1 - delivered / target flux)^2 keeps the optimizer from throwing
    light away.  As in the reference, the target is divided by its raw sum."""
    img = render_lens_image(
        patches_from_vertices(params, topo), params.refractive_index,
        start, direction, screen_plane, extent=extent, resolution=resolution,
    )
    t_sum = target.sum()
    i_sum = img.sum().clamp_min(1e-12)
    pattern = torch.mean((img / i_sum - target / t_sum) ** 2) * resolution ** 2
    flux = (1.0 - i_sum / t_sum) ** 2
    return pattern + flux_weight * flux, img


def make_design_step(topo: DesignTopology, screen_plane, target,
                     resolution: int = 64, extent: float = 4.0,
                     flux_weight: float = 0.1):
    """Optimizer design step: (params, opt, start, direction) -> (params,
    opt, loss), like `lens_model.make_opt_train_step`.  `opt` is a
    `torch.optim.Optimizer` over params.parameters(); the parameters move in
    place and the loss returned is that of the iterate before the update."""

    def step(params: DesignParams, opt, start, direction):
        opt.zero_grad(set_to_none=True)
        loss, _ = design_loss(params, topo, start, direction, screen_plane, target,
                              resolution=resolution, extent=extent,
                              flux_weight=flux_weight)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    return step


def cosine_decay(n_steps: int):
    """optax.cosine_decay_schedule's factor as a LambdaLR multiplier: step t
    runs at 0.5 * (1 + cos(pi * min(t, n) / n)) of the peak, so step 0 runs
    at the peak."""
    if n_steps <= 0:
        raise ValueError(f"a stage needs a positive number of steps, got {n_steps}")
    return lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, n_steps) / n_steps))


def fit_design(mesh, target, start, direction, screen_plane,
               steps: int = 0, learning_rate: float = 5e-4,
               stages=None, resolution: int = 64, extent: float = 4.0,
               refractive_index: float = 1.3, flux_weight: float = 0.1,
               on_step=None, device="cuda"):
    """Run a full mesh-vertex design fit on `device`.

    stages: list of (peak_lr, steps) Adam phases, each with a cosine decay
    to 0 (`torch.optim.lr_scheduler.LambdaLR` stepped after each update)
    and each restarted, with fresh moments, from the best iterate so far.
    Default: one (learning_rate, steps) stage.

    Returns (best_params, topo, losses): losses is the whole trajectory.
    The bookkeeping is the reference's: a step's loss is that of the iterate
    before its update, but the parameters kept as the best are those after
    it, one step past the best loss (their own loss is never evaluated).
    A non-finite loss raises FloatingPointError.
    """
    if stages is None:
        stages = [(learning_rate, steps)]
    topo, params = topology_from_mesh(mesh, device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    start, direction = start.to(device), direction.to(device)
    screen_plane = screen_plane.to(device)
    step = make_design_step(topo, screen_plane, target, resolution=resolution,
                            extent=extent, flux_weight=flux_weight)

    def snapshot(p):
        return p.vertices.detach().clone(), p.refractive_index.detach().clone()

    best = (float("inf"), (params.vertices.detach(), torch.tensor(refractive_index)))
    losses = []
    i = 0
    for peak_lr, n_steps in stages:
        params = DesignParams(*best[1])
        opt = torch.optim.Adam(params.parameters(), lr=peak_lr)
        schedule = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(n_steps))
        for _ in range(n_steps):
            params, opt, loss = step(params, opt, start, direction)
            schedule.step()
            loss = float(loss)
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite design loss at step {i}")
            losses.append(loss)
            if loss < best[0]:
                best = (loss, snapshot(params))
            if on_step:
                on_step(i, loss)
            i += 1
    return DesignParams(*best[1]), topo, losses
