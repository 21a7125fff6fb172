"""The kernels' cull, probed on the card: what it lists, what it costs, and
how the winner search's time splits into a floor and a cost per pair.

Counterpart of benchmarks/cull_probe.py, with the time decomposition of K1
and K2.  Three parts:

* per shape (robot 450 on K1; refined 1800 and split-4 7200 on K2; the
  first 65,536 rays of the 256^2 grid): the listed (tile x block) fraction
  with the AABB leg off and on, from the kernel's own per-tile counts; the
  kernel alone (`launch` on tables built once) timed both ways; whether
  both ways give identical winners;
* the decomposition (`decomposition_rows`), K1 at 262,144 x 450 and K2 at
  262,144 x 1800 (the robot and the refined robot at 512^2), three rows at
  the same shape, each the kernel alone with the pairs it evaluated
  (counted by the kernel):
  (a) every block culled: the rays turned away from the lens;
  (b) none culled: the same tables with every live block's bounds and
      every patch's gate sphere and box widened to hold every ray
      (`uncull_inputs`), so every (ray, patch) pair is evaluated; its
      winners are held against the unculled reference;
  (c) the lens as it is;
  the floor is t(a), the cost a pair (t(b) - t(a)) / (pairs(b) - pairs(a)),
  and the predicted t(c) = t(a) + cost x (pairs(c) - pairs(a)) stands
  beside the measured one (pairs(a) is 0 unless some block's bounds hold
  the rays' origins);
* the block size (`block_size_rows`): K1 at blocks of 16 patches (the
  port's) and of 32 (the JAX package's above its ray cap) on the robot at
  1024^2 and on the first 1,048,576 rays of the 4096^2 grid: the rays
  whose winner differs, and which side the unculled reference takes.

On the CPU (--device cpu) the kernels' plain twins stand in: the counts
are `tile_block_lists`', the times the host's, and the decomposition, which
times kernels, is not run.

    python -m cbtr_tpu_torch.benchmarks.cull_probe [--rays N] [--res N]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from ..ops import cuda_sweep as cs
from ..ops import cuda_winner as cw
from . import records

# (name, robot_lens_scene arguments, kernel) of the per-shape rows
SHAPES = (("robot_450", {}, "K1"), ("refined_1800", {"refine": True}, "K2"),
          ("split4_7200", {"split": 4}, "K2"))
# the decomposition's shapes: (name, scene arguments, kernel), 512^2 rays
DECOMPOSITION_SHAPES = (("K1 262,144 x 450", {}, "K1"),
                        ("K2 262,144 x 1800", {"refine": True}, "K2"))
# a radius and a box half-width that hold every ray of every scene: the cull
# squares the radius (1e12) and scales the box by a slab reciprocal of at
# most 1e30 (block_walk.cuh slab_inv), both far inside f32's 3.4e38
WIDE = 1e6


def _kernel(kernel: str):
    """(prepare_inputs, launch, wrapper) of K1 or K2."""
    if kernel == "K1":
        return cs.prepare_inputs, cs.launch, cs.sweep_select
    return cw.prepare_inputs, cw.launch, cw.sweep_winner


def listed_counts(patches, start, direction, use_aabb: bool, kernel: str = "K1"):
    """(per-tile listed blocks [T], evaluated pairs): the kernel's own counts
    for CUDA tensors; for CPU tensors the list builder's (`tile_block_lists`,
    equal to the kernel's) and the pairs the kernel's first pass evaluates
    (K1: `evaluated_pairs`, K2: `gated_pairs`).  Pairs are pass 1 plus the
    retries on the card, pass 1 alone on the CPU."""
    prepare, launch, _ = _kernel(kernel)
    if start.is_cuda:
        out = launch(prepare(patches, start, direction, use_aabb), pairs=True)
        return out.counts, int(out.pairs.sum())
    rays_t = cs.pad_rays(start, direction)
    counts, lists = cs.tile_block_lists(patches, rays_t, use_aabb=use_aabb)
    patch_t = cs.pack_patch_table(patches)
    listed = cs.listed_blocks(counts, lists, patch_t.shape[0])
    sphere = cs.sphere_hit_pairs(patch_t, rays_t)
    if kernel == "K1":
        pairs = cs.evaluated_pairs(listed, sphere,
                                   cs.box_hit_pairs(cs.patch_box_table(patches), rays_t))
    else:
        pairs = cs.gated_pairs(listed, sphere)
    return counts, int(pairs[:start.shape[0], :patches.num_patches].sum())


def probe_shape(patches, start, direction, kernel: str, windows: int = 5) -> dict:
    """One shape's row: listed fractions, pairs and times with the AABB leg
    off and on, and whether both ways give identical winners."""
    prepare, launch, wrapper = _kernel(kernel)
    dev = start.device
    B = -(-patches.num_patches // cs.BLOCK_P)     # live blocks (the JAX probe's count)
    row = {"patches": patches.num_patches, "rays": start.shape[0], "kernel": kernel}
    winners = []
    for tag, aabb in (("sphere", False), ("aabb", True)):
        counts, pairs = listed_counts(patches, start, direction, aabb, kernel)
        row[f"exec_frac_{tag}"] = int(counts.sum()) / (counts.numel() * B)
        row[f"pairs_{tag}"] = pairs
        if start.is_cuda:
            inputs = prepare(patches, start, direction, aabb)
            row[f"ms_{tag}"] = records.window_stats(lambda: launch(inputs), dev, windows)
        else:
            row[f"ms_{tag}"] = records.window_stats(
                lambda: wrapper(patches, start, direction, use_aabb=aabb), dev, 1, 1, 0)
        winners.append(wrapper(patches, start, direction, use_aabb=aabb))
    (h0, w0, _), (h1, w1, _) = winners
    row["identical"] = bool(torch.equal(h0, h1) and torch.equal(w0[h0], w1[h1]))
    return row


def shape_rows(device, rays: int = 65536, res: int = 256) -> dict:
    """`probe_shape` at every one of SHAPES on the first `rays` rays of the
    res^2 grid, the scenes built one at a time."""
    from ..models import robot_lens_scene

    out = {}
    for name, kw, kernel in SHAPES:
        sc = robot_lens_scene(res=res, device=device, **kw)
        out[name] = probe_shape(sc.patches, sc.start[:rays], sc.direction[:rays], kernel)
        print(name, json.dumps(out[name]), flush=True)
        del sc
    return out


def uncull_inputs(inputs: cs.KernelInputs) -> cs.KernelInputs:
    """The same tables with nothing culled: every live block's sphere and box
    (`block_bounds` columns), every real patch's gate sphere (the patch
    table's radius column) and its box (K1's `patch_box_table`) widened to
    WIDE, so every block is listed for every tile and gated open, every pair
    passes K1's per-pair test, and K2's neighbour-sphere gate always holds.
    All-padding blocks keep radius -1 and padding rows radius 0 and their
    zero box."""
    bounds = inputs.bounds.clone()
    live = bounds[:, cs._BND_RADIUS] >= 0.0
    bounds[live, cs._BND_RADIUS] = WIDE
    bounds[live, cs._BND_LO:cs._BND_LO + 3] = -WIDE
    bounds[live, cs._BND_HI:cs._BND_HI + 3] = WIDE
    patch_t = inputs.patch_t.clone()
    radius = cs._ROW_BSPHERE + 3
    real = patch_t[:, radius] > 0.0
    patch_t[real, radius] = WIDE
    boxes = inputs.boxes.clone()
    boxes[real, 0:3] = -WIDE
    boxes[real, 3:6] = WIDE
    return dataclasses.replace(inputs, bounds=bounds, patch_t=patch_t, boxes=boxes)


def _rays_differ(a, b) -> int:
    """Rays whose (any_hit, winner) differ between two results."""
    return int(((a[0] != b[0]) | (a[0] & b[0] & (a[1] != b[1]))).sum())


def decomposition_rows(device, windows: int = 7) -> list[dict]:
    """K1 and K2, each: rows (a), (b), (c) (module docstring) with ms alone,
    pairs, the floor, the cost a pair, the predicted and measured t(c); (b)'s
    winners against the unculled reference (rays that differ) and (c)'s
    against the wrapper's.  Needs the card: it times kernels."""
    from ..models import robot_lens_scene

    dev = records.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the decomposition times the kernels: it needs a CUDA device")
    rows = []
    for name, kw, kernel in DECOMPOSITION_SHAPES:
        prepare, launch, wrapper = _kernel(kernel)
        sc = robot_lens_scene(res=512, device=dev, **kw)
        p, s, d = sc.patches, sc.start, sc.direction
        R = s.shape[0]
        cases = {"a_all_culled": prepare(p, s, -d), "c_as_is": prepare(p, s, d)}
        cases["b_none_culled"] = uncull_inputs(cases["c_as_is"])
        row = {"shape": name, "kernel": kernel, "rays": R, "patches": p.num_patches}
        outs = {}
        for case in ("a_all_culled", "b_none_culled", "c_as_is"):
            inputs = cases[case]
            out = launch(inputs, pairs=True)
            outs[case] = out
            row[case] = {"ms": records.window_stats(lambda: launch(inputs), dev, windows, 3,
                                                    2)["median_ms"],
                         "pairs": int(out.pairs.sum()),
                         "pass1_pairs": int(out.pairs[:, 0].sum()),
                         "listed_blocks": int(out.counts.sum())}
        ta, tb, tc = (row[c]["ms"] for c in ("a_all_culled", "b_none_culled", "c_as_is"))
        pa, pb, pc = (row[c]["pairs"] for c in ("a_all_culled", "b_none_culled", "c_as_is"))
        # (a) may keep a few pairs (a patch whose sphere reaches the rays'
        # origins): the floor holds them, the cost a pair is over the rest
        per_pair = (tb - ta) / (pb - pa)
        predicted = ta + per_pair * (pc - pa)
        row.update(floor_ms=ta, ns_per_pair=per_pair * 1e6, predicted_c_ms=predicted,
                   measured_c_ms=tc, measured_over_predicted=tc / predicted)
        unculled = cs.sweep_select_reference(p, s, d, cull=False)
        b = outs["b_none_culled"]
        b_res = (b.dist[:R] < cs._BIG_F * 0.5, b.win[:R])
        row["b_rays_differ_from_unculled_reference"] = _rays_differ(b_res, unculled)
        c = outs["c_as_is"]
        got = wrapper(p, s, d)
        row["c_rays_differ_from_wrapper"] = _rays_differ(
            (c.dist[:R] < cs._BIG_F * 0.5, c.win[:R]), got)
        row["c_rays_differ_from_unculled_reference"] = _rays_differ(got, unculled)
        rows.append(row)
        print("decomposition", json.dumps(row), flush=True)
        del sc, cases, outs, unculled
        torch.cuda.empty_cache()
    return rows


def block_size_row(patches, start, direction, label: str, chunk: int = 1 << 18) -> dict:
    """K1 (its twin on the CPU) at blocks of 16 and 32 on the same rays: the
    rays whose winner differs and, on those rays, which block size the
    unculled reference (every pair evaluated) agrees with."""
    def k1(block_p):
        if start.is_cuda:
            out = cs.launch(cs.prepare_inputs(patches, start, direction, block_p=block_p))
            R = start.shape[0]
            return out.dist[:R] < cs._BIG_F * 0.5, out.win[:R]
        return cs.sweep_select_reference(patches, start, direction, block_p=block_p)[:2]

    w16, w32 = k1(cs.BLOCK_P), k1(32)
    differ = (w16[0] != w32[0]) | (w16[0] & w32[0] & (w16[1] != w32[1]))
    rays = torch.nonzero(differ)[:, 0]
    row = {"shape": label, "rays": start.shape[0], "patches": patches.num_patches,
           "hits_block16": int(w16[0].sum()), "rays_differ": int(rays.numel())}
    sides = {"block16": 0, "block32": 0, "neither": 0}
    for r0 in range(0, rays.numel(), chunk):
        idx = rays[r0:r0 + chunk]
        full = cs.sweep_select_reference(patches, start[idx], direction[idx], cull=False)

        def agrees(w):
            return (w[0][idx] == full[0]) & (~full[0] | (w[1][idx] == full[1]))

        a16, a32 = agrees(w16), agrees(w32)
        sides["block16"] += int((a16 & ~a32).sum())
        sides["block32"] += int((a32 & ~a16).sum())
        sides["neither"] += int((~a16 & ~a32).sum())
    row["unculled_reference_sides_with"] = sides
    return row


def block_size_rows(device) -> list[dict]:
    """`block_size_row` on the robot at 1024^2 and on the first 1,048,576
    rays of the 4096^2 grid (the tiled order the 4K scripts trace)."""
    from ..models import robot_lens_scene, scene_ortho_grid

    dev = records.resolve_device(device)
    sc = robot_lens_scene(res=1024, device=dev)
    rows = [block_size_row(sc.patches, sc.start, sc.direction, "robot 1024^2")]
    s, d = scene_ortho_grid(4096).rays_at(torch.arange(1 << 20, device=dev))
    rows.append(block_size_row(sc.patches, s, d, "robot, first 1,048,576 rays of 4096^2"))
    for row in rows:
        print("block size", json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=65536)
    ap.add_argument("--res", type=int, default=256)
    records.add_output_args(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = records.resolve_device(args.device)
    rec = {"shapes": shape_rows(dev, args.rays, args.res)}
    if dev.type == "cuda":
        rec["decomposition"] = decomposition_rows(dev)
    else:
        rec["decomposition"] = "not measured (it times the kernels: the card only)"
    rec["block_size"] = block_size_rows(dev)
    rec.update(records.card_fields(dev))
    records.emit(rec, args.out, args.label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
