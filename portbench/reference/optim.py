"""Adam as `torch.optim.Adam` defines it at its defaults (betas 0.9 and
0.999, eps 1e-8, no weight decay), written out for the reference's float64
parameters."""
from __future__ import annotations

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def adam_step(params: dict, grads: dict, state: dict, lr: float) -> dict:
    """The parameters after one step; `state` (the moments and the step
    count, empty before the first step) is updated in place."""
    t = state["t"] = state.get("t", 0) + 1
    out = {}
    for k, p in params.items():
        g = grads[k]
        m = state[("m", k)] = BETA1 * state.get(("m", k), 0.0) + (1.0 - BETA1) * g
        v = state[("v", k)] = BETA2 * state.get(("v", k), 0.0) + (1.0 - BETA2) * g * g
        m_hat = m / (1.0 - BETA1 ** t)
        v_hat = v / (1.0 - BETA2 ** t)
        out[k] = p - lr * m_hat / (v_hat.sqrt() + EPS)
    return out
