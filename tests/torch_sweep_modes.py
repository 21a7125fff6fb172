"""Shared by tests/test_torch_fast_newton.py and tests/test_torch_bf16_sweep.py.

The fixture is the JAX tests' (tests/test_fast_newton.py,
tests/test_bf16_sweep.py): the sphere lens scene at res 8, 9 sectors, 4
belts (216 patches) and 512 rays made with numpy from seed 7.  `run_jax`
runs the JAX package's three Pallas sweep kernels in interpret mode with
one of its opt-in flags set, in a fresh process (the JAX package reads its
flags while it traces), and returns their outputs with the patches and
rays; `port_twins` runs the port's twins of K1-K3 on the same inputs in a
mode.
"""
import os
import subprocess
import sys

import numpy as np
import torch

from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.ops import cuda_codes as cc
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import cuda_winner as cw
from cbtr_tpu_torch.ops import intersect as ix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from cbtr_tpu.config import DEFAULT as CFG

object.__setattr__(CFG, sys.argv[2], True)

import jax.numpy as jnp
from cbtr_tpu.models import sphere_lens_scene
from cbtr_tpu.ops import pallas_sweep as ps

scene = sphere_lens_scene(res=8, sectors=9, belts=4)
rng = np.random.default_rng(7)
n = 512
start = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
start[:, 0] -= 3.0
target = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
d = target - start
d /= np.linalg.norm(d, axis=-1, keepdims=True)
s, dd = jnp.asarray(start), jnp.asarray(d)
out = {"start": start, "direction": d}
out.update({f"patch_{k}": np.asarray(v) for k, v in scene.patches._asdict().items()})
for name, fn in (("k1", ps.sweep_select_pallas), ("k2", ps.sweep_winner_pallas),
                 ("k3", ps.sweep_codes_pallas)):
    for i, x in enumerate(fn(scene.patches, s, dd, interpret=True)):
        out[f"{name}_{i}"] = np.asarray(x)
np.savez(sys.argv[1], **out)
"""


def run_jax(path, flag: str, xla_flags: str | None = None) -> dict:
    """The JAX package's K1, K2 and K3 in interpret mode with config.<flag>
    on, in a fresh process with XLA_FLAGS = xla_flags (none by default):
    {"k1_0".."k1_2", "k2_0".."k2_2", "k3_0", "k3_1", "patch_<leaf>",
    "start", "direction"} as numpy arrays."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    if xla_flags:
        env["XLA_FLAGS"] = xla_flags
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(path), flag],
                          capture_output=True, text=True, timeout=560, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def port_inputs(jax_out):
    """(patches, start, direction) of the JAX run, as the port's CPU tensors."""
    leaves = {k[len("patch_"):]: v for k, v in jax_out.items() if k.startswith("patch_")}
    return (patches_from_numpy(leaves, device="cpu"), torch.tensor(jax_out["start"]),
            torch.tensor(jax_out["direction"]))


def port_twins(patches, start, direction, mode) -> dict:
    """The twins of K1, K2 and K3 in `mode` (an `intersect.SweepMode`), keyed
    as `run_jax`'s outputs."""
    with ix.using_mode(mode):
        outs = {"k1": cs.sweep_select_reference(patches, start, direction),
                "k2": cw.sweep_winner_reference(patches, start, direction),
                "k3": cc.sweep_codes_reference(patches, start, direction)}
    return {f"{k}_{i}": x.numpy() for k, v in outs.items() for i, x in enumerate(v)}


def winner_counts(port, ref, kernel: str):
    """(rays whose any_hit differs, common hits whose winner differs, common
    hits whose distance differs beyond rtol = atol = 1e-4, common hits) of
    a winner kernel's two runs."""
    ah, win, dist = (port[f"{kernel}_{i}"] for i in range(3))
    ah_r, win_r, dist_r = (ref[f"{kernel}_{i}"] for i in range(3))
    both = ah & ah_r
    far = ~np.isclose(dist[both], dist_r[both], rtol=1e-4, atol=1e-4)
    return (int((ah != ah_r).sum()), int((win != win_r)[both].sum()), int(far.sum()),
            int(both.sum()))


def code_counts(port, ref):
    """K3's (pairs whose code differs, cIntersect pairs of both whose
    distance differs beyond rtol 1e-4, beyond rtol 1e-3, cIntersect pairs
    of both)."""
    code, dist, code_r, dist_r = port["k3_0"], port["k3_1"], ref["k3_0"], ref["k3_1"]
    inter = ((code & 7) == ix.WHAT_INTERSECT) & ((code_r & 7) == ix.WHAT_INTERSECT)
    rel = np.abs(dist[inter] - dist_r[inter]) / np.abs(dist_r[inter])
    return (int((code != code_r).sum()), int((rel > 1e-4).sum()), int((rel > 1e-3).sum()),
            int(inter.sum()))


def intersect_agreement(patches, start, direction, mode):
    """tests/test_fast_newton.py's comparison: `intersect_rays` (the twin of
    K1 on CPU tensors, then the exact recompute) in `mode` against the
    exact mode: (hit agreement, winner agreement on common hits, common-hit
    distances in mode, the same in the exact mode, common hits with the same
    winner as a mask over them)."""
    exact = ix.intersect_rays(patches, start, direction)
    with ix.using_mode(mode):
        got = ix.intersect_rays(patches, start, direction)
    ha, hb = (got.what == ix.WHAT_INTERSECT), (exact.what == ix.WHAT_INTERSECT)
    both = ha & hb
    same = got.patch[both] == exact.patch[both]
    return (float((ha == hb).float().mean()), float(same.float().mean()),
            got.distance[both].numpy(), exact.distance[both].numpy(), same.numpy())
