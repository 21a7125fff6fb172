"""The plain reference against the port's own oracles, on the CPU (a test
may import the port; the reference does not): its frozen build equals the
port's float64 build, and its pair-list tracer gives the scalar float64
tracer's winners and refracted rays ray by ray."""
from __future__ import annotations

import numpy as np
import torch

from cbtr_tpu_torch.harness.reference_tracer import R_INSIDE, ReferenceTracer
from cbtr_tpu_torch.models import robot_lens_scene

from portbench import cell as cells
from portbench.reference import scene, tracer


def _cell(name):
    return cells.find_cell(cells.load_benchmark(), name)


def test_frozen_build_equals_the_ports_float64_build(monkeypatch):
    """On the port's NumPy host stage (its native one rounds the vertex
    normals in another order)."""
    monkeypatch.setenv("CBTR_NATIVE", "0")
    c = _cell("robot450-fit512")
    ours = scene.build_patches(cells.mesh_path(c), c.config["lens_center"], False, "cpu")
    port = robot_lens_scene(res=1, path=cells.mesh_path(c), device="cpu",
                            dtype=torch.float64).patches
    for name in ("control_points", "underlying", "dividers", "bary_inverse", "heights",
                 "deriv_b", "neighbours"):
        assert torch.equal(getattr(ours, name), getattr(port, name)), name


def test_pair_tracer_matches_the_scalar_tracer():
    c = _cell("robot450-fit512")
    lens = scene.build_lens(c.config, cells.mesh_path(c), "cpu")
    oracle = ReferenceTracer(scene.build_patches(cells.mesh_path(c), c.config["lens_center"],
                                                 False, "cpu"))
    beam = {"center": (0.0, 0.013, -0.021), "direction": (1.0, 0.0, 0.0),
            "up": (0.0, 0.0, 1.0), "width": 1.8, "res": 24}
    s, d = (x.double() for x in scene.ortho_rays(beam, torch.arange(576)))
    rng = np.random.default_rng(5)
    rows = rng.choice(576, 160, replace=False)
    s1, d1, st1, hit = tracer.refract(lens, s[rows], d[rows], tracer.R_INSIDE)
    live = 0
    for i, r in enumerate(rows):
        best = oracle.intersect(s[r].numpy(), d[r].numpy())
        assert int(hit.patch[i]) == (-1 if best is None else best["patch"])
        ns, nd, st = oracle.refract(s[r].numpy(), d[r].numpy(), 1.3, R_INSIDE)
        assert int(st1[i]) == st
        np.testing.assert_allclose(s1[i].numpy(), ns, rtol=0, atol=1e-12)
        np.testing.assert_allclose(d1[i].numpy(), nd, rtol=0, atol=1e-12)
        live += st == R_INSIDE
    assert live > 5
