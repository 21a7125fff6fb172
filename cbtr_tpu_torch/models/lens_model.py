"""The differentiable lens model: optimize a Bezier lens by gradient descent.

Counterpart of cbtr_tpu/models/lens_model.py.  Pixels of the rendered
irradiance image are differentiable w.r.t. the lens control points and the
refractive index, so a target illumination pattern can be fit.

The lens is an `nn.Module`: `control_points` and `refractive_index` are
Parameters; everything else in the BezierPatches tables (planes, heights,
inverse matrices, dividers, neighbours) is a buffer holding the values built
from the initial control net.  The tables are NOT rebuilt as the control
points move — the JAX package's semantics, consistent for small steps;
rebuild with `bezier.build_patches` for large ones.  Because the module holds
the tables, the JAX functions' separate `patches` argument is absorbed into
`params` here.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import torch
from torch import nn

from .. import config
from ..bezier.patches import BezierPatches
from ..ops import cuda_lib, cuda_recompute, intersect
from ..optics import lens
from ..render import render
from ..render.render import render_lens_image
from ..utils import profiling
from ..utils.profiling import span

_TABLES = ("neighbours", "underlying", "dividers", "bary_inverse", "heights",
           "deriv_b")


class LensParams(nn.Module):
    """Lens parameters (control_points [P,10,3], refractive_index scalar) and
    the built tables they index into (buffers)."""

    def __init__(self, patches: BezierPatches, refractive_index):
        super().__init__()
        cp = patches.control_points.detach()
        self.control_points = nn.Parameter(cp.to(torch.float32).clone())
        self.refractive_index = nn.Parameter(torch.as_tensor(
            refractive_index, dtype=torch.float32, device=cp.device).detach().clone())
        for name in _TABLES:
            self.register_buffer(name, getattr(patches, name).detach().clone())

    def patches(self) -> BezierPatches:
        return BezierPatches(control_points=self.control_points,
                             **{name: getattr(self, name) for name in _TABLES})

    def forward(self, start, direction, screen_plane, resolution: int = 128,
                extent: float = 4.0, chunk_size: int = 0, ray_weights=None,
                backend: str = "auto"):
        return render_lens_image(
            self.patches(), self.refractive_index, start, direction,
            screen_plane, extent=extent, resolution=resolution,
            chunk_size=chunk_size, weights=ray_weights, backend=backend,
        )


def params_from_scene(scene) -> LensParams:
    return LensParams(scene.patches, scene.refractive_index)


def lens_forward(params: LensParams, start, direction, screen_plane,
                 resolution: int = 128, extent: float = 4.0,
                 chunk_size: int = 0, ray_weights=None, backend: str = "auto"):
    """Irradiance image for the current lens parameters.

    ray_weights: optional per-ray multiplier; 0 removes a ray."""
    return params(start, direction, screen_plane, resolution=resolution,
                  extent=extent, chunk_size=chunk_size,
                  ray_weights=ray_weights, backend=backend)


def lens_loss(params: LensParams, start, direction, screen_plane, target,
              resolution: int = 128, extent: float = 4.0, chunk_size: int = 0,
              ray_weights=None, backend: str = "auto"):
    img = lens_forward(
        params, start, direction, screen_plane, resolution=resolution,
        extent=extent, chunk_size=chunk_size, ray_weights=ray_weights,
        backend=backend,
    )
    return torch.mean((img - target) ** 2)


def make_train_step(screen_plane, target, resolution: int = 128,
                    extent: float = 4.0, learning_rate: float = 1e-3,
                    chunk_size: int = 0, backend: str = "auto"):
    """SGD step: (params, start, direction) -> (params, loss).

    Updates the parameters in place (p <- p - lr * grad) and returns the
    same module with the detached loss.  The step is the span `cbtr.step`,
    its loss, backward and update `cbtr.step.forward`, `.backward` and
    `.update` (`utils.profiling`)."""

    @span("cbtr.step")
    def step(params: LensParams, start, direction):
        params.zero_grad(set_to_none=True)
        with span("cbtr.step.forward"):
            loss = lens_loss(params, start, direction, screen_plane, target,
                             resolution=resolution, extent=extent,
                             chunk_size=chunk_size, backend=backend)
        with span("cbtr.step.backward"):
            loss.backward()
        with span("cbtr.step.update"), torch.no_grad():
            for p in (params.control_points, params.refractive_index):
                p -= learning_rate * p.grad
        return params, loss.detach()

    return step


def make_opt_train_step(screen_plane, target, resolution: int = 128,
                        extent: float = 4.0, chunk_size: int = 0):
    """Optimizer step for lens design runs: (params, opt, start, direction)
    -> (params, opt, loss).

    Counterpart of the JAX package's optax step (the plain SGD of
    `make_train_step` converges too slowly on the stiff control-point loss
    surface of the car-lamp scenario, reference/README.md:159-165).  `opt`
    is a `torch.optim.Optimizer` over [params.control_points,
    params.refractive_index], e.g. `torch.optim.Adam(..., lr=lr)`, which
    has optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8).  The loss is
    `lens_loss`, as in `make_train_step`; the parameters move in place.
    On the card the step captures its loss and backward as one CUDA graph
    and replays it (`OptTrainStep`).  Its spans are `make_train_step`'s,
    the update `opt.step()`."""
    return OptTrainStep(screen_plane, target, resolution, extent, chunk_size)


# The module-level functions that the step's forward looks up by name at
# each call, as (module, attribute).  A step replays its graph only while
# each is bound as it was when this module was imported, so that a caller's
# wrapper or hook runs (eagerly) rather than being skipped by a replay.
GRAPH_PATH = ((sys.modules[__name__], "render_lens_image"),
              (render, "trace_through_lens"), (render, "screen_hits"),
              (render, "splat_bilinear"), (lens, "refract_rays"),
              (lens, "intersect_rays"), (lens, "winner_tables"),
              (intersect, "_winner_chunk"), (intersect, "recompute_winner"))
_PATH_BOUND = tuple(getattr(module, name) for module, name in GRAPH_PATH)


def eager_reason(device, rays_need_grad: bool = False) -> Optional[str]:
    """Why `OptTrainStep` runs its eager body on rays on `device`, or None
    where it may capture and replay: rays off the card, grad mode off,
    rays that need a gradient (the graph's static rays need none),
    `profiling.counting()` or `spans_on()` on (the pair counters and the
    per-layer ranges exist only on the eager path), or a function of
    `GRAPH_PATH` re-bound.  `profiling.timing()` alone replays: the span
    `cbtr.step` then times the replay."""
    if torch.device(device).type != "cuda":
        return "rays off the card"
    if not torch.is_grad_enabled():
        return "grad mode off"
    if rays_need_grad:
        return "rays need a gradient"
    if profiling.counting_enabled():
        return "counting() on"
    if profiling.recording_enabled():
        return "spans_on() on"
    for (module, name), bound in zip(GRAPH_PATH, _PATH_BOUND):
        if getattr(module, name) is not bound:
            return f"{module.__name__}.{name} re-bound"
    return None


def graph_key(params: LensParams, opt, start, direction) -> tuple:
    """What a captured step depends on besides the numbers in its tensors:
    the parameter module and the optimizer, where each parameter and buffer
    lives and whether it needs a gradient, the rays' shapes, types and
    device, and the configuration every layer reads at each call (the
    sweep's modes and the Newton count among it).  The graph reads each
    tensor at its address: a parameter or buffer given new storage needs a
    new capture."""
    tensors = (*params.parameters(), *params.buffers())
    return (params, opt, tuple((t.data_ptr(), t.requires_grad) for t in tensors),
            *((t.shape, t.dtype, t.device) for t in (start, direction)),
            *(tuple(vars(c).values()) for c in (config.DEFAULT, intersect.CFG,
                                                cuda_recompute.CFG)))


class _Graph(NamedTuple):
    """One captured loss and backward: its key, the graph (which owns its
    memory pool), the static rays it reads, the loss and the gradients it
    writes, and the kernel launches it recorded ({kernel: launches})."""

    key: tuple
    graph: "torch.cuda.CUDAGraph"
    start: torch.Tensor
    direction: torch.Tensor
    loss: torch.Tensor
    grads: tuple
    launches: dict


class OptTrainStep:
    """`make_opt_train_step`'s step, which adapts to what it observes.

    Eagerly (`eager_reason`, or a first call with a key): the loss, its
    backward and `opt.step()`, the gradients set to None first.  On the
    second eligible call with the same `graph_key` it captures the loss and
    the backward as one CUDA graph, by torch's whole-network recipe: the
    rays copied into static buffers, a warm-up on a side stream, the
    gradients set to None so that the captured backward writes them.  Each
    later eligible call with that key copies the rays into the static
    buffers, replays the graph, points each parameter's `.grad` at the
    graph's gradient and runs `opt.step()` eagerly (the optimizer and its
    state stay outside the graph), returning a clone of the graph's loss.
    A replay adds the launches its capture recorded to the kernels' counts
    (`cuda_lib.add_launches`).  The graph and its memory pool belong to this
    object: a new key drops them, and so does dropping the step.  The
    replayed `.grad` tensors are the graph's, written again at the next
    replay.  Under `profiling.timing()` each call counts as
    `cbtr.step.capture`, `.replay` or `.eager`."""

    def __init__(self, screen_plane, target, resolution: int = 128,
                 extent: float = 4.0, chunk_size: int = 0):
        self.screen_plane, self.target = screen_plane, target
        self.resolution, self.extent, self.chunk_size = resolution, extent, chunk_size
        self._warmed: Optional[tuple] = None    # the key of the last warm-up
        self._graph: Optional[_Graph] = None

    def _loss(self, params, start, direction):
        return lens_loss(params, start, direction, self.screen_plane, self.target,
                         resolution=self.resolution, extent=self.extent,
                         chunk_size=self.chunk_size)

    def path(self, key: tuple) -> str:
        """"replay" while this key's graph is held, "capture" on the second
        eligible call with a key, else "eager": the first call with a key
        warms up, and drops the graph of another key."""
        if self._graph is not None and self._graph.key == key:
            return "replay"
        if self._warmed == key:
            return "capture"
        self._graph, self._warmed = None, key
        return "eager"

    @span("cbtr.step")
    def __call__(self, params: LensParams, opt, start, direction):
        path, key = "eager", None
        if eager_reason(start.device, start.requires_grad or direction.requires_grad) is None:
            key = graph_key(params, opt, start, direction)
            path = self.path(key)
        profiling.count(f"cbtr.step.{path}")
        if path == "eager":
            opt.zero_grad(set_to_none=True)
            with span("cbtr.step.forward"):
                loss = self._loss(params, start, direction)
            with span("cbtr.step.backward"):
                loss.backward()
        else:
            loss = self._replay(path, key, params, opt, start, direction)
        with span("cbtr.step.update"):
            opt.step()
        return params, opt, loss.detach()

    def _replay(self, path, key, params, opt, start, direction):
        """The graph (captured first where `path` is "capture") replayed on
        these rays, each parameter's `.grad` the graph's; returns a clone
        of the graph's loss."""
        if path == "capture":
            self._graph = self._capture(key, params, opt, start, direction)
        else:
            self._graph.start.copy_(start)
            self._graph.direction.copy_(direction)
        graph = self._graph
        graph.graph.replay()
        if path == "replay":
            cuda_lib.add_launches(graph.launches)
        opt.zero_grad(set_to_none=True)
        for p, grad in graph.grads:
            p.grad = grad
        return graph.loss.clone()

    def _capture(self, key, params, opt, start, direction) -> _Graph:
        """The loss and backward captured on static copies of the rays, under
        `key` (the graph not yet replayed)."""
        device = start.device
        static = [torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)
                  for t in (start, direction)]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            opt.zero_grad(set_to_none=True)
            self._loss(params, *static).backward()
        torch.cuda.current_stream(device).wait_stream(side)
        opt.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, stream=side):
                loss = self._loss(params, *static)
                loss.backward()
            return loss

        loss, launches = cuda_lib.counted(capture)
        grads = tuple((p, p.grad) for p in params.parameters() if p.grad is not None)
        return _Graph(key, graph, *static, loss.detach(), grads, launches)
