"""The port's probes and small benchmarks (cull_probe, winner_probe,
inflation_probe, solve3x3_bench, gen_perf_table) on the CPU, and every
script's default device: the card, or an error.

The cull and inflation probes run on the sphere fixture (the JAX sphere
scene's tables, handed to the port through `patches_from_numpy`) against
the numbers the JAX probes compute on the same rays.
"""
import importlib
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbtr_tpu.models import sphere_lens_scene as jax_sphere_scene
from cbtr_tpu.models.fit import emitter_rays as jax_emitter_rays
from cbtr_tpu.ops import pallas_sweep as jax_ps

from cbtr_tpu_torch.benchmarks import (
    cull_probe,
    gen_perf_table,
    inflation_probe,
    solve3x3_bench,
    winner_probe,
)
from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.ops import cuda_sweep as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))
import inflation_probe as jax_inflation_probe  # noqa: E402  (the JAX script)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sphere():
    """The JAX sphere scene (15 x 7, 630 patches) at 32^2 rays, and the port's
    view of the same tables and rays."""
    scene = jax_sphere_scene(res=32)
    port = types.SimpleNamespace(
        patches=patches_from_numpy({k: np.asarray(v) for k, v in
                                    scene.patches._asdict().items()}, device="cpu"),
        start=torch.tensor(np.asarray(scene.start)).reshape(-1, 3),
        direction=torch.tensor(np.asarray(scene.direction)).reshape(-1, 3))
    return scene, port


# ---- cull_probe ----------------------------------------------------------------


def test_cull_probe_fractions_match_the_jax_probe(sphere):
    """The listed (tile x block) fractions with the AABB leg off and on: the
    JAX probe's expression (its list builder's counts over T x ceil(P/16))
    and the port's row equal; both ways give identical winners."""
    scene, port = sphere
    row = cull_probe.probe_shape(port.patches, port.start, port.direction, "K1", windows=1)
    rays_t = cs.pad_rays(port.start, port.direction).numpy()
    P = scene.patches.num_patches
    for tag, aabb in (("sphere", False), ("aabb", True)):
        counts, _ = jax_ps.tile_block_lists(scene.patches, jnp.asarray(rays_t), 128,
                                            jax_ps.FUSED_BLOCK_P, aabb)
        want = float(np.asarray(counts).sum()) / (rays_t.shape[1] // 128 * -(-P // 16))
        assert row[f"exec_frac_{tag}"] == pytest.approx(want, rel=0, abs=1e-12)
        assert row[f"pairs_{tag}"] > 0 and row[f"ms_{tag}"]["n"] == 1
    assert 0 < row["exec_frac_aabb"] <= row["exec_frac_sphere"] <= 1
    assert row["identical"] and row["kernel"] == "K1" and row["patches"] == P


def test_uncull_inputs_evaluate_every_pair(sphere):
    """(b) of the decomposition: with `uncull_inputs` every live block is
    listed for every tile and every real (ray, patch) pair passes the gate,
    so the kernels evaluate every pair (their function is then the unculled
    reference's); all-padding blocks keep radius -1, padding rows radius 0;
    the widened cull stays finite in f32 (a slab reciprocal is at most
    1e30)."""
    _, port = sphere
    # the first 100 patches: a table of 128 rows, its last block all padding
    patches = type(port.patches)(**{k: v[:100] for k, v in port.patches.leaves().items()})
    inputs = cs.prepare_inputs(patches, port.start, port.direction)
    wide = cull_probe.uncull_inputs(inputs)
    live = inputs.bounds[:, cs._BND_RADIUS] >= 0
    assert live.tolist() == [True] * 7 + [False]
    torch.testing.assert_close(wide.bounds[~live], inputs.bounds[~live], rtol=0, atol=0)
    bitmap = cs.tile_bitmap_reference(wide.bounds, wide.rays_t)
    assert torch.equal(bitmap, live[None].expand_as(bitmap))
    P = patches.num_patches
    sphere_ok = cs.sphere_hit_pairs(wide.patch_t, wide.rays_t)
    assert bool(sphere_ok[:, :P].all()) and not bool(sphere_ok[:, P:].any())
    pairs = cs.evaluated_pairs(bitmap, sphere_ok)[:port.start.shape[0], :P]
    assert bool(pairs.all())
    assert (cull_probe.WIDE + 10.0) * 1e30 < float(torch.finfo(torch.float32).max)
    assert torch.equal(wide.rays_t, inputs.rays_t) and torch.equal(wide.nb, inputs.nb)


def test_block_size_row_counts_and_sides(sphere):
    """K1's twin at blocks of 16 and 32 on the sphere: every differing ray is
    put on one side (or neither) by the unculled reference."""
    _, port = sphere
    row = cull_probe.block_size_row(port.patches, port.start, port.direction, "sphere 32^2")
    assert row["rays"] == 1024 and row["hits_block16"] > 500
    assert sum(row["unculled_reference_sides_with"].values()) == row["rays_differ"]


def test_decomposition_needs_the_card():
    with pytest.raises(ValueError, match="CUDA device"):
        cull_probe.decomposition_rows("cpu")


# ---- winner_probe, inflation_probe, solve3x3_bench ------------------------------


def test_winner_probe_row(sphere):
    """K2's twin, intersect_rays and the staged path on the sphere: the plain
    path agrees on every ray (the wrapper runs the twin on the CPU)."""
    _, port = sphere
    scene = types.SimpleNamespace(patches=port.patches, start=port.start,
                                  direction=port.direction)
    row = winner_probe.probe_scene("sphere", scene, iters=1)
    assert row["agreement"] == 1.0 and row["agreement_rays"] == 1024
    assert row["patches"] == 630 and row["staged_rays_differ_from_winner"] <= 4
    assert row["winner_kernel_ms"] > 0 and row["intersect_rays_per_s"] > 0


def test_inflation_probe_matches_the_jax_probe(sphere):
    """`measure` on the sphere's ortho grid and on emitter_rays(4096, 16, 1)
    against the JAX probe's `measure` on the same tables and rays.  The
    winners' inflations (by the hit point and by the ray line) within 1e-4
    relative, the candidate counts within 0.5 % (measured 0.22 %: hits of
    rays grazing a patch border come and go with the last bits).  The two
    maxima over all candidates are not compared by value: each is one
    knife-edge pair (on the grid's first 1,024 rays 8,958 follow-side pairs
    hold 1 voter in the JAX package and 2 in the port, pairs whose
    barycentric coordinate lies on a border of [0, 1]; a retry candidate
    of a grazing ray converges far outside its patch), so the grid's reads
    3.597 here and 3.556 in the JAX probe, the emitter's 2.619 and 3.116.
    Both packages find it above 1 (no blanket inflation covers every
    candidate: the JAX package's round-5 finding) and the voters' at most
    it."""
    scene, port = sphere
    es, ed = jax_emitter_rays(4096, belts=16, seed=1)
    for s, d in ((scene.start, scene.direction), (es, ed)):
        got = inflation_probe.measure(port, np.asarray(s), np.asarray(d))
        want = jax_inflation_probe.measure(scene, s, d)
        np.testing.assert_allclose(got[2:4], want[2:4], rtol=1e-4)
        assert min(got[0], want[0]) > 1.0
        assert got[1] <= got[0] and want[1] <= want[0]
        assert abs(got[4] - want[4]) <= 5e-3 * want[4]


def test_solve3x3_strategies_agree():
    """The three solves of 10,000 well-conditioned systems: allclose to each
    other and to the float64 solution; the precomputed inverse's mat-vec
    is the inverse-then-multiply bit for bit (the same operations)."""
    m, v = solve3x3_bench.systems(10000, "cpu")
    out = {name: solve() for name, solve in solve3x3_bench.strategies(m, v).items()}
    exact = np.linalg.solve(m.double().numpy(), v.double().numpy()[..., None])[..., 0]
    for x in out.values():
        assert x.shape == (10000, 3)
        np.testing.assert_allclose(x.numpy(), exact, rtol=1e-4, atol=1e-5)
    assert torch.equal(out["adjugate inverse + multiply"], out["precomputed-inverse mat-vec"])


# ---- gen_perf_table ----------------------------------------------------------------

_BENCH = {"metric": "rays/s fwd+bwd", "value": 2063680.9, "unit": "rays/s",
          "card": "NVIDIA H100 80GB HBM3, 700.00 W", "kernel_plain_agreement": 1.0,
          "filler": "x" * 3000,
          "robot_1024": {"rays": 1048576, "rays_per_s": 5293909.9,
                         "stats_ms": {"median_ms": 198.0, "n": 5}},
          "robot_split6": {"rays": 65536, "intersect_rays_per_s": 3050000.5},
          "fma_peak_tflops": 63.9}


def _wrapped_record(tmp_path, name, parsed):
    line = json.dumps(_BENCH)
    rec = {"n": 9, "cmd": "python -m cbtr_tpu_torch.bench", "rc": 0,
           "tail": line[-2000:], "parsed": parsed}
    (tmp_path / name).write_text(json.dumps(rec))
    return line


def test_salvage_reads_what_a_cut_line_holds(tmp_path):
    """parsed null and a tail that starts inside the "filler" string: the
    values whose keys stand whole at the top level come back (nested
    objects included), the cut ones do not, nested keys never pose as
    top-level ones."""
    line = _wrapped_record(tmp_path, "BENCH_cut.json", None)
    got = gen_perf_table.load_record(str(tmp_path / "BENCH_cut.json"))
    assert got["salvaged"] is True
    assert got["robot_1024"] == _BENCH["robot_1024"] and got["fma_peak_tflops"] == 63.9
    assert "value" not in got and "card" not in got and "rays" not in got
    assert gen_perf_table.salvage(line)["value"] == 2063680.9
    assert gen_perf_table.salvage(line[:-5]) == {}        # the line's end cut too


def test_table_prints_a_dash_for_what_is_missing(tmp_path):
    _wrapped_record(tmp_path, "BENCH_a_cut.json", None)
    _wrapped_record(tmp_path, "BENCH_b_whole.json", _BENCH)
    table = gen_perf_table.build_table(str(tmp_path))
    head, _, card, value, r1024 = table.splitlines()[:5]
    assert head == "| metric | a_cut | b_whole |"
    assert value == "| rays/s fwd+bwd, robot 512×512 (headline) | — | 2,063,681 |"
    assert r1024.endswith("| 5,293,910 | 5,293,910 |")
    assert "| — | NVIDIA H100 80GB HBM3, 700.00 W |" in card


def test_table_takes_records_in_pr_order(tmp_path):
    """pr10 comes after pr9 (a plain sort of the names puts it first): the
    BENCH columns run pr9, pr10, and the large-scale row cites pr10."""
    _wrapped_record(tmp_path, "BENCH_pr9.json", _BENCH)
    _wrapped_record(tmp_path, "BENCH_pr10.json", _BENCH)
    for pr, wall in (("pr9", 0.835), ("pr10", 0.733)):
        (tmp_path / f"RENDER4K_{pr}.json").write_text(json.dumps(
            {"rays": 16777216, "wall_s": wall, "rays_per_s": 16777216 / wall,
             "chunk": 1048576, "peak_memory_gib": 3.0, "card": "H100"}))
    table = gen_perf_table.build_table(str(tmp_path))
    assert table.splitlines()[0] == "| metric | pr9 | pr10 |"
    assert "0.733 s wall" in table and "RENDER4K_pr10.json" in table
    assert "0.835 s wall" not in table


def test_check_tells_a_stale_table_from_a_fresh_one(tmp_path):
    """--check exits 1 on a stale table and rewrites nothing; a run writes the
    table between the markers only (the TPU record's BENCH block and the
    text around stay); --check then passes."""
    art = tmp_path / "torch_artifacts"
    art.mkdir()
    _wrapped_record(art, "BENCH_x.json", _BENCH)
    (art / "RENDER4K_x.json").write_text(json.dumps(
        {"rays": 16777216, "wall_s": 0.838, "rays_per_s": 20012824.0, "chunk": 1048576,
         "peak_memory_gib": 3.08, "card": "NVIDIA H100 80GB HBM3, 700.00 W"}))
    tpu = "<!-- BENCH:BEGIN (generated by benchmarks/gen_perf_table.py) -->\nold\n<!-- BENCH:END -->"
    doc = f"# PERF\n\n{gen_perf_table.BEGIN}\nstale\n{gen_perf_table.END}\n\n{tpu}\n"
    perf = tmp_path / "PERF.md"
    perf.write_text(doc)
    args = ["--perf", str(perf), "--artifacts", str(art)]
    assert gen_perf_table.main(args + ["--check"]) == 1
    assert perf.read_text() == doc
    assert gen_perf_table.main(args) == 0
    new = perf.read_text()
    assert new != doc and tpu in new and "stale" not in new
    assert "| 4K render (16.8M rays, fwd) | 20,012,824 rays/s, 0.838 s wall, peak 3.08 GiB" in new
    assert gen_perf_table.main(args + ["--check"]) == 0


def test_wrap_keeps_the_tail_and_parses_the_last_line(tmp_path):
    log = tmp_path / "bench.log"
    log.write_text("progress\n" + json.dumps(_BENCH) + "\n")
    rec = gen_perf_table.wrap(str(log), "python -m cbtr_tpu_torch.bench", 0, "L")
    assert rec["parsed"] == _BENCH and len(rec["tail"]) == 2000 and rec["label"] == "L"
    log.write_text("progress\n" + json.dumps(_BENCH)[:-3] + "\n")
    assert gen_perf_table.wrap(str(log), "c")["parsed"] is None


# ---- the card, or an error ----------------------------------------------------------

_SCRIPTS = {
    "design_lens": ["--smoke"], "multiprocess_render": ["--procs", "1"],
    "render4k": ["--gpu"], "train4k": ["--gpu"], "emitter4k": [],
    "scaling_bench": [], "cull_probe": [], "winner_probe": [], "inflation_probe": [],
    "solve3x3_bench": [],
}


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_script_defaults_to_the_card(name):
    """Each script's default device is the card: without one it raises at
    once (no quiet fall-back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    mod = importlib.import_module(f"cbtr_tpu_torch.benchmarks.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(_SCRIPTS[name])
