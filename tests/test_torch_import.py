"""The PyTorch port imports without jax, and without nvcc.

The machine with the GPU has no jax, and the CUDA kernel is built at first
use, not at import: importing every module of the port must work on a
CPU-only machine with neither.
"""
import os
import subprocess
import sys

_SCRIPT = r"""
import os, shutil, sys
os.environ["PATH"] = ""          # no nvcc (nor anything else) on PATH
import cbtr_tpu_torch
import cbtr_tpu_torch.ops.cuda_lib as cl
import cbtr_tpu_torch.ops.cuda_sweep
import cbtr_tpu_torch.ops.cuda_winner
import cbtr_tpu_torch.ops.cuda_codes
import cbtr_tpu_torch.ops.cuda_tables
import cbtr_tpu_torch.ops.cuda_segment
import cbtr_tpu_torch.ops.cuda_recompute
import cbtr_tpu_torch.ops.cuda_emitter
import cbtr_tpu_torch.harness.determinism
import cbtr_tpu_torch.benchmarks.fma_peak
import cbtr_tpu_torch.bench
import cbtr_tpu_torch.harness.reference_tracer
import cbtr_tpu_torch.harness.kernel_ab
import cbtr_tpu_torch.harness.profile_step
import cbtr_tpu_torch.models.fit
import cbtr_tpu_torch.render.emitters
import cbtr_tpu_torch.render.ray_sort
import cbtr_tpu_torch.bezier.refine
import cbtr_tpu_torch.bezier.tessellate
import cbtr_tpu_torch.harness.measure
import cbtr_tpu_torch.models.lens_model
import cbtr_tpu_torch.models.scenes
import cbtr_tpu_torch.convert
import cbtr_tpu_torch.render.render
import cbtr_tpu_torch.utils
import cbtr_tpu_torch.utils.checkpoint
import cbtr_tpu_torch.utils.profiling
import cbtr_tpu_torch.utils.prng
import cbtr_tpu_torch.models.design
import cbtr_tpu_torch.parallel
import cbtr_tpu_torch.parallel.sharding
import cbtr_tpu_torch.parallel.patch_parallel
import cbtr_tpu_torch.parallel.multihost
import cbtr_tpu_torch.entry
import cbtr_tpu_torch.native as nat
import cbtr_tpu_torch.harness.drivers
import cbtr_tpu_torch.harness.visual
import cbtr_tpu_torch.benchmarks.records
import cbtr_tpu_torch.benchmarks.design_lens
import cbtr_tpu_torch.benchmarks.multiprocess_render
import cbtr_tpu_torch.benchmarks.render4k
import cbtr_tpu_torch.benchmarks.train4k
import cbtr_tpu_torch.benchmarks.emitter4k
import cbtr_tpu_torch.benchmarks.scaling_bench
import cbtr_tpu_torch.benchmarks.cull_probe
import cbtr_tpu_torch.benchmarks.winner_probe
import cbtr_tpu_torch.benchmarks.inflation_probe
import cbtr_tpu_torch.benchmarks.solve3x3_bench
import cbtr_tpu_torch.benchmarks.gen_perf_table
import torch.distributed as dist
from cbtr_tpu_torch.harness.drivers import followers_report, follow_triples
from cbtr_tpu_torch.harness.reference_tracer import (FastReferenceTracer,
    oracle_screen_hits, landing_disagreement)
from cbtr_tpu_torch.ops.intersect import candidates_with_retry, select_best
from cbtr_tpu_torch.geom import (perimeter, to_which_side, plane_project,
    ray_sphere_hit, ritter_bounding_sphere, divide_triangle_np)
from cbtr_tpu_torch.mesh.stl_io import write_stl, write_stl_binary
from cbtr_tpu_torch.render import (OrthoGrid, DeviceEmitter, sample_hemisphere,
    angle_sweep_rays, pinhole_ray_grid, render_emitter_image,
    render_emitter_image_device, render_surface_normals)
from cbtr_tpu_torch.models import (fit_lens, fit_emitter_lens, emitter_rays,
    make_opt_train_step, scene_ortho_grid)
from cbtr_tpu_torch.utils import (save_params, load_params, save_patches,
    load_patches, counting, span, spans_on, timing, trace)
from cbtr_tpu_torch.utils.checkpoint import latest_checkpoint
from cbtr_tpu_torch.utils.prng import prng_key, fold_in, split, uniform
assert shutil.which("nvcc") is None
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not any(m == "cbtr_tpu" or m.startswith("cbtr_tpu.") for m in sys.modules)
assert cl.loaded() == set()      # no kernel library built or loaded
assert cl.launch_counts() == dict.fromkeys(cl.KERNELS, 0) and len(cl.KERNELS) == 10
assert not dist.is_initialized()  # importing the parallel layer starts no group
assert nat._lib is None and nat.build_error() is None   # no g++ run, nothing loaded
if os.path.exists("/proc/self/maps"):
    with open("/proc/self/maps") as maps:
        assert "libcbtr_" not in maps.read()      # no library of the port mapped
print("IMPORT_OK")
"""


def test_port_imports_without_jax_or_nvcc():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
        timeout=120, cwd=repo,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORT_OK" in proc.stdout


def test_cpu_wrapper_runs_the_twin_without_launching():
    """On CPU tensors the kernel wrapper computes the plain twin; it never
    builds or launches the kernel (and its launch count stays put)."""
    import torch

    from cbtr_tpu_torch.mesh.core import make_unit_sphere
    from cbtr_tpu_torch.harness import preprocess
    from cbtr_tpu_torch.bezier import build_from_trimesh
    from cbtr_tpu_torch.ops import cuda_lib
    from cbtr_tpu_torch.ops import cuda_sweep as cs

    patches = build_from_trimesh(preprocess(make_unit_sphere(7, 3)), device="cpu")
    rng = torch.Generator().manual_seed(0)
    start = torch.randn(40, 3, generator=rng) * 0.1 - torch.tensor([3.0, 0, 0])
    direction = torch.nn.functional.normalize(
        torch.randn(40, 3, generator=rng) * 0.4 - start, dim=-1)
    got, launches = cuda_lib.counted(lambda: cs.sweep_select(patches, start, direction))
    want = cs.sweep_select_reference(patches, start, direction)
    assert launches["sweep_select"] == 0
    assert "sweep_select" not in cuda_lib.loaded()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].sum() >= 10


def test_entry_declares_argtypes_once_and_refuses_others(monkeypatch):
    """A C entry point takes the argtypes of its first declaration; a later
    one that names others raises instead of being dropped."""
    import ctypes
    from types import SimpleNamespace

    import pytest

    from cbtr_tpu_torch.ops import cuda_lib

    fn = SimpleNamespace(argtypes=None, restype=None)
    monkeypatch.setattr(cuda_lib, "library", lambda stem: SimpleNamespace(cbtr_stub=fn))
    args = [ctypes.c_void_p, ctypes.c_int]
    assert cuda_lib.entry("stub", "cbtr_stub", args) is fn
    assert fn.argtypes == args and fn.restype is ctypes.c_int
    assert cuda_lib.entry("stub", "cbtr_stub", list(args)) is fn
    with pytest.raises(TypeError, match="cbtr_stub"):
        cuda_lib.entry("stub", "cbtr_stub", [ctypes.c_void_p, ctypes.c_long])
    assert fn.argtypes == args
