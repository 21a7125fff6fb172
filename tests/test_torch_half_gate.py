"""K1's half_gate in the port, and the sweep modes' way into the kernels.

`cuda_sweep.sweep_select(..., half_gate=True)` and its twin gate each half
of a listed block (block_p / 2 patches) by its own sphere test, as the JAX
package's `sweep_select_pallas(half_gate=True)` does at block_p >= 16
(pallas_sweep.py:681): an ungated half leaves its pairs WHAT_NONE, so none
of them is a direct candidate or a retry.  The twin runs against that
kernel in interpret mode on tests/test_torch_sweep.py's fixtures, with the
same bar and the same excused rays (the 2 robot rays on which the JAX
package's own kernel and its XLA path, here the unculled twin, disagree); on
both fixtures the winners are the ones without the half gate.

The C entry points' arguments: every launch passes the mode config asks
for (`intersect.sweep_mode().code`) and, on K1, half_gate, in the places
the ctypes signatures declare (a stub library on CPU tensors).
"""
import contextlib

import numpy as np
import pytest
import torch

from cbtr_tpu.bezier import build_from_trimesh as jax_build
from cbtr_tpu.harness.measure import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import make_unit_sphere as jax_sphere
from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.ops import pallas_sweep as jax_ps

from cbtr_tpu_torch.config import DEFAULT as CFG
from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.ops import cuda_codes as cc
from cbtr_tpu_torch.ops import cuda_lib
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import cuda_winner as cw
from cbtr_tpu_torch.ops import intersect as ix

torch.set_num_threads(2)


def _numpy_leaves(patches):
    return {k: np.asarray(v) for k, v in patches._asdict().items()}


@pytest.fixture(scope="module")
def cases():
    """name -> (jax patches, port patches, start, direction):
    tests/test_torch_sweep.py's sphere fan of 1024 rays and robot 32^2."""
    rng = np.random.default_rng(3)
    start = rng.normal(size=(1024, 3)).astype(np.float32) * 0.1
    start[:, 0] -= 3.0
    target = rng.normal(size=(1024, 3)).astype(np.float32) * 0.4
    d = target - start
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sphere = jax_build(jax_preprocess(jax_sphere(7, 3), use_native=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBTR_NATIVE", "0")
        scene = jax_scenes.robot_lens_scene(res=32)
    return {
        "sphere1024": (sphere, patches_from_numpy(_numpy_leaves(sphere), device="cpu"),
                       start, d),
        "robot1024": (scene.patches,
                      patches_from_numpy(_numpy_leaves(scene.patches), device="cpu"),
                      np.asarray(scene.start), np.asarray(scene.direction)),
    }


def _twin(port_p, start, d, **kw):
    return tuple(x.numpy() for x in cs.sweep_select_reference(
        port_p, torch.tensor(start), torch.tensor(d), **kw))


@pytest.mark.parametrize("case,block_p", [("sphere1024", 16), ("robot1024", 16),
                                          ("robot1024", 32)])
def test_half_gate_twin_matches_pallas(cases, case, block_p):
    ref_p, port_p, start, d = cases[case]
    ref = [np.asarray(x) for x in jax_ps.sweep_select_pallas(
        ref_p, start, d, interpret=True, block_p=block_p, half_gate=True)]
    # the unculled twin stands in for the JAX package's XLA path
    # (tests/test_torch_sweep.py holds the two equal on every ray here)
    excused = ref[0] != _twin(port_p, start, d, cull=False)[0]
    assert excused.sum() <= (2 if case == "robot1024" else 0)
    got = _twin(port_p, start, d, block_p=block_p, half_gate=True)
    keep = ~excused
    any_p, win_p, d_p = (x[keep] for x in got)
    any_r, win_r, d_r = (x[keep] for x in ref)
    np.testing.assert_array_equal(any_p, any_r)
    both = any_p & any_r
    assert both.sum() >= 16, "fixture too weak"
    np.testing.assert_array_equal(win_p[both], win_r[both])
    np.testing.assert_allclose(d_p[both], d_r[both], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["sphere1024", "robot1024"])
def test_half_gate_keeps_the_winners(cases, case):
    """The twin with the half gate and without: the same winners here."""
    _, port_p, start, d = cases[case]
    for a, b in zip(_twin(port_p, start, d, half_gate=True), _twin(port_p, start, d)):
        np.testing.assert_array_equal(a, b)


def test_half_gate_evaluates_fewer_pairs(cases):
    """On the robot the half gate drops pairs (never adds one), and each
    half's pairs are evaluated iff the half is listed and some pair of it
    passes the sphere test (a loop over halves in NumPy)."""
    _, port_p, start, d = cases["robot1024"]
    rays_t = cs.pad_rays(torch.tensor(start), torch.tensor(d))
    patch_t = cs.pack_patch_table(port_p)
    listed = cs.listed_blocks(*cs.tile_block_lists(port_p, rays_t), patch_t.shape[0])
    sphere = cs.sphere_hit_pairs(patch_t, rays_t)
    whole = cs.evaluated_pairs(listed, sphere).numpy()
    half = cs.evaluated_pairs(listed, sphere, half_gate=True).numpy()
    assert half.sum() < whole.sum() and not (half & ~whole).any()
    sph, lst = sphere.numpy(), listed.numpy()
    want = np.zeros_like(half)
    unit = cs.BLOCK_P // 2
    for t in range(lst.shape[0]):
        rows = slice(t * cs.TILE_R, (t + 1) * cs.TILE_R)
        for u in range(patch_t.shape[0] // unit):
            cols = slice(u * unit, (u + 1) * unit)
            if lst[t, u * unit // cs.BLOCK_P] and sph[rows, cols].any():
                want[rows, cols] = True
    np.testing.assert_array_equal(half, want)


def test_half_gate_refusals(cases):
    _, port_p, start, d = cases["sphere1024"]
    s, dd = torch.tensor(start[:128]), torch.tensor(d[:128])
    with pytest.raises(ValueError, match="half_gate"):
        cs.sweep_select_reference(port_p, s, dd, block_p=8, half_gate=True)
    with pytest.raises(ValueError, match="half_gate"):
        cs.sweep_select_reference(port_p, s, dd, cull=False, half_gate=True)
    with pytest.raises(ValueError, match="half_gate"):
        cs.occupancy("winner", 512, half_gate=True)


class _StubEntry:
    """A kernel's C entry point that records its arguments."""

    def __init__(self):
        self.argtypes, self.restype, self.calls = None, None, []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _StubLibrary:
    """A kernel library whose every entry point records its arguments."""

    def __init__(self):
        self.entries = {}

    def __getattr__(self, symbol):
        return self.entries.setdefault(symbol, _StubEntry())


@pytest.fixture
def stubbed(monkeypatch):
    """Launches on CPU tensors: the device checks pass, the library records."""
    libs = {}

    def library(stem):
        return libs.setdefault(stem, _StubLibrary())

    class _Stream:
        cuda_stream = 1234

    monkeypatch.setattr(cs, "check_inputs", lambda inputs, kernel: (
        inputs.rays_t.shape[1] // cs.TILE_R, inputs.patch_t.shape[0]))
    monkeypatch.setattr(cc, "check_inputs", lambda inputs: (
        inputs.rays_t.shape[1] // cs.TILE_R, inputs.patch_t.shape[0]))
    monkeypatch.setattr(cuda_lib, "library", library)
    # the stubs' launches are counted apart from the process's
    monkeypatch.setattr(cuda_lib, "_launches", dict.fromkeys(cuda_lib.KERNELS, 0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _Stream())
    saved = CFG.fast_newton, CFG.bf16_sweep
    yield libs
    object.__setattr__(CFG, "fast_newton", saved[0])
    object.__setattr__(CFG, "bf16_sweep", saved[1])


@pytest.mark.parametrize("mode", list(ix.MODES))
@pytest.mark.parametrize("kernel", ["K1", "K1 half_gate", "K2", "K3"])
def test_launch_passes_the_mode(cases, stubbed, kernel, mode):
    """The entry point gets every argument its signature declares, the mode
    code second to last but one (K1: then half_gate) and the stream last."""
    _, port_p, start, d = cases["sphere1024"]
    s, dd = torch.tensor(start[:256]), torch.tensor(d[:256])
    with ix.using_mode(ix.MODES[mode]):
        if kernel == "K3":
            cc.launch(cc.prepare_inputs(port_p, s, dd))
        elif kernel == "K2":
            cw.launch(cw.prepare_inputs(port_p, s, dd))
        else:
            cs.launch(cs.prepare_inputs(port_p, s, dd), half_gate=kernel.endswith("gate"))
    stem = {"K1": "sweep_select", "K2": "winner", "K3": "sweep_codes"}[kernel.split()[0]]
    entry = getattr(stubbed[stem], f"cbtr_{stem}")
    (args,) = entry.calls
    assert len(args) == len(entry.argtypes)
    assert args[-1] == 1234
    code = ix.MODES[mode].code
    if stem == "sweep_select":
        assert args[-3:-1] == (code, int(kernel.endswith("gate")))
    else:
        assert args[-2] == code
