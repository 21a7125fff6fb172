"""The work counter of the roofline shares: its pair test against a brute
force count, and its operation count a pair recounted."""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import cell as cells
from portbench.reference import scene, tracer
from portbench.work import pairs, sweep

_COUNTED = {"add", "sub", "mul", "div", "neg", "abs", "sqrt", "maximum", "minimum"}


def _lens():
    c = cells.find_cell(cells.load_benchmark(), "robot450-fit512")
    return scene.build_lens(c.config, cells.mesh_path(c), "cpu")


def _rays(res=24, spread=0.0):
    beam = {"center": (0.0, 0.0, 0.0), "direction": (1.0, 0.0, 0.0), "up": (0.0, 0.0, 1.0),
            "width": 1.8, "res": res}
    s, d = scene.ortho_rays(beam, torch.arange(res * res))
    d = d + spread * torch.randn(d.shape, generator=torch.Generator().manual_seed(0))
    return s.double(), d.double() / d.double().norm(dim=-1, keepdim=True)


def test_pairs_against_brute_force():
    lens = _lens()
    s, d = _rays(spread=0.05)
    center, radius, lo, hi = pairs.patch_bounds(lens.control_points)
    brute = 0
    for r in range(s.shape[0]):
        for p in range(center.shape[0]):
            rel = center[p] - s[r]
            t_ca = float(rel @ d[r])
            rel2 = float(rel @ rel)
            r2 = float(radius[p]) ** 2
            sphere = rel2 - t_ca * t_ca <= r2 and (t_ca >= 0.0 or rel2 <= r2)
            inv = 1.0 / d[r]
            t1, t2 = (lo[p] - s[r]) * inv, (hi[p] - s[r]) * inv
            near = float(torch.minimum(t1, t2).max())
            far = float(torch.maximum(t1, t2).min())
            brute += sphere and far >= 0.0 and near <= far
    assert pairs.count_pairs((center, radius, lo, hi), s, d) == brute > 0
    rr, pp = pairs.candidate_pairs((center, radius, lo, hi), s, d)
    assert rr.shape[0] == brute and bool((rr[1:] >= rr[:-1]).all())


def test_the_cull_drops_no_pass1_candidate():
    """Every pair whose gate-on candidate is an intersection or a follow
    side passes the pair test (the reference's filter is lossless)."""
    lens = _lens()
    s, d = _rays(res=16)
    P = lens.control_points.shape[0]
    r = torch.arange(s.shape[0]).repeat_interleave(P)
    q = torch.arange(P).repeat(s.shape[0])
    what, *_ = tracer.evaluate(lens, q, s[r], d[r], True)
    live = what != tracer.W_NONE
    kept = set(zip(*(x.tolist() for x in pairs.candidate_pairs(
        pairs.patch_bounds(lens.control_points), s, d))))
    assert live.any()
    assert all((a, b) in kept for a, b in zip(r[live].tolist(), q[live].tolist()))


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.__name__.split(".")[0].rstrip("_") in _COUNTED
                and isinstance(out, torch.Tensor) and out.is_floating_point()):
            self.n += out.numel()
        return out


def test_pair_ops_recounted():
    lens = _lens()
    lens32 = tracer.Lens(*(x.float() if x.is_floating_point() else x for x in lens))
    s, d = _rays(res=16)
    with _Count() as c:
        tracer.evaluate(lens32, torch.tensor([7]), s[:1].float(), d[:1].float(), True)
    assert c.n == sweep.PAIR_OPS == 1566


def test_bound_scales_a_sample():
    lens = _lens()
    s, d = _rays(res=32)
    full = sweep.bound(lens, s, d, s.shape[0])
    assert full["bound_by"] == "operations" and full["pairs"] > full["pairs_pass2"] > 0
    idx = sweep.sample_indices(s.shape[0], "cpu")
    assert idx.shape[0] == s.shape[0]
    part = sweep.bound(lens, s[::2], d[::2], s.shape[0])
    assert abs(part["pairs"] / full["pairs"] - 1.0) < 0.1
