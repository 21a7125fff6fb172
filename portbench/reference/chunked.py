"""The plain reference of one data-parallel SGD step, in float64, over rays
in chunks.

The port's `parallel/sharding.py::sgd_step` renders the image, takes the
loss `mean((img - target)^2)` and moves the parameters by
`p <- p - lr * grad`.  `tracer.loss_and_grads` differentiates that loss
through one trace of every ray at once, whose autograd graph grows with the
rays: at 16.8 M rays its saved tensors alone outgrow an 80 GB card.  The
image is linear in the rays, so the same gradient is the sum over chunks of
each chunk's image backed by one cotangent:

1. the image, summed over chunks without gradients (`tracer.render`);
2. the cotangent of the loss, `2 (img - target) / res^2`;
3. each chunk traced again with autograd on (`tracer.trace`) and its
   image's vector-Jacobian product with the cotangent added up, for the
   control points and the refractive index;
4. the plain SGD update.

`tracer.py`'s functions are used unchanged; nothing here imports the port.
"""
from __future__ import annotations

import torch

from . import tracer

LEAVES = ("control_points", "refractive_index")


def loss_and_grads(lens: tracer.Lens, start, direction, screen_plane, target, extent: float,
                   chunk: int, keep_rays: bool = False):
    """(loss, d loss / d control points, d loss / d refractive index, trace)
    of `tracer.loss_and_grads`, over rays in chunks of `chunk`.  trace: the
    image and, with keep_rays, each pass's per-ray fields (`tracer.Trace`);
    else None."""
    res = target.shape[0]
    image, trace = tracer.render(lens, start, direction, screen_plane, extent, res,
                                 chunk=chunk, keep_rays=keep_rays)
    loss = torch.mean((image - target) ** 2)
    cotangent = 2.0 * (image - target) / image.numel()
    cp = lens.control_points.detach().requires_grad_(True)
    ri = lens.refractive_index.detach().requires_grad_(True)
    live = lens._replace(control_points=cp, refractive_index=ri)
    g_cp, g_ri = torch.zeros_like(cp), torch.zeros_like(ri)
    for r0 in range(0, start.shape[0], chunk):
        t = tracer.trace(live, start[r0:r0 + chunk], direction[r0:r0 + chunk], screen_plane,
                         extent, res)
        a, b = torch.autograd.grad(t.image, (cp, ri), cotangent)
        g_cp += a
        g_ri += b
        del t, a, b
    return loss.detach(), g_cp, g_ri, trace


def sgd_update(params: dict, grads: dict, learning_rate: float) -> dict:
    """`p - lr * g` for each leaf of `params` (new tensors)."""
    return {k: params[k] - learning_rate * grads[k] for k in LEAVES}
