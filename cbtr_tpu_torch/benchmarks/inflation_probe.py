"""How much per-patch sphere inflation the cull actually needs.

Counterpart of benchmarks/inflation_probe.py.  `cuda_sweep.patch_spheres`
(and the table kernel after it) inflates every control-net sphere by a
blanket 25 % so that gate-OFF follow-side candidates, which converge a
little outside the patch domain, stay inside the cull.  This probe measures
what is needed instead: for every (ray, patch) candidate the select stage
can consume

* retry targets and direct hits: what_off == cIntersect,
* voters: in_dom and what_off a cFollowSide,

the distance of the candidate point from the control-net centre, and
reports max over candidates of (|f - c| + max_ray_dist) / r_hull, the
smallest per-mesh inflation that keeps every such candidate's ray inside
the sphere (acceptance needs the ray within max_intersection_distance_from_ray
of f), and the same over the winners alone, by their hit point and by the
ray line's distance from the winner's centre (what the cull tests).

It runs the unculled sweep (`intersect.patch_candidates`, limit_domain
False) on the six fixtures, each on its ortho grid and on
`emitter_rays(4096, 16, 1)`, in ray chunks.

    python -m cbtr_tpu_torch.benchmarks.inflation_probe [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json

import torch

from ..config import DEFAULT as CFG
from ..ops.intersect import WHAT_INTERSECT, WHAT_NONE, patch_candidates, select_candidates
from . import records


def measure(scene, start, direction, chunk: int = 2048):
    """(need over all candidates, over voters, over winners, over winners by
    the ray line, number of candidates) for the rays start/direction [..., 3]
    (rays padded to a chunk multiple head -x from the origin and miss)."""
    patches = scene.patches
    dev = patches.device
    cp = patches.control_points.detach().to(torch.float32)         # [P,10,3]
    center = cp.mean(dim=1)
    r_hull = torch.linalg.vector_norm(cp - center[:, None], dim=-1).amax(dim=-1)
    r_hull = r_hull.clamp_min(1e-12)
    s_all = torch.as_tensor(start, dtype=torch.float32, device=dev).reshape(-1, 3)
    d_all = torch.as_tensor(direction, dtype=torch.float32, device=dev).reshape(-1, 3)
    pad = (-s_all.shape[0]) % chunk
    if pad:
        s_all = torch.cat([s_all, s_all.new_zeros(pad, 3)])
        filler = d_all.new_zeros(pad, 3)
        filler[:, 0] = -1.0
        d_all = torch.cat([d_all, filler])

    worst = torch.zeros(4, dtype=torch.float32, device=dev)
    n_cand = 0
    with torch.no_grad():
        for c0 in range(0, s_all.shape[0], chunk):
            s, d = s_all[c0:c0 + chunk], d_all[c0:c0 + chunk]
            what, dist, pt, _, b, _ = patch_candidates(patches, s[:, None, :],
                                                       d[:, None, :], False)
            in_dom = ((b >= 0.0) & (b <= 1.0)).all(dim=-1)
            hit_off = what == WHAT_INTERSECT
            voter = in_dom & (what < WHAT_NONE)
            keep = hit_off | voter
            off = torch.linalg.vector_norm(pt - center[None], dim=-1)   # [R,P]
            need = (off + CFG.max_intersection_distance_from_ray) / r_hull[None]
            code = what | (in_dom.to(torch.int32) << 3)
            any_hit, win, _ = select_candidates(code, dist, patches.neighbours)
            win = win.to(torch.int64)
            win_need = need.gather(1, win[:, None])[:, 0]
            # the cull passes iff the ray hits the sphere: the radius it
            # needs is the ray line's distance from the winner's centre
            rel = center[win] - s
            t_ca = (rel * d).sum(dim=-1)
            rel2 = (rel * rel).sum(dim=-1)
            d_perp2 = torch.where(t_ca >= 0.0, (rel2 - t_ca * t_ca).clamp_min(0.0), rel2)
            ray_need = torch.sqrt(d_perp2) / r_hull[win]
            chunk_worst = torch.stack([
                torch.where(keep, need, 0.0).amax(),
                torch.where(voter, need, 0.0).amax(),
                torch.where(any_hit, win_need, 0.0).amax(),
                torch.where(any_hit, ray_need, 0.0).amax()])
            worst = torch.maximum(worst, chunk_worst)
            n_cand += int(keep.sum())
    w, wv, ww, wr = (float(x) for x in worst.cpu())
    return w, wv, ww, wr, n_cand


def fixtures(device):
    """(name, scene) of the six fixture families, built one at a time."""
    from ..models import (
        dimpled_lens_scene,
        ellipsoid_lens_scene,
        robot_lens_scene,
        sphere_lens_scene,
    )

    yield "sphere", sphere_lens_scene(res=64, device=device)
    yield "ellipsoid", ellipsoid_lens_scene(res=64, device=device)
    yield "dimpled", dimpled_lens_scene(res=64, device=device)
    yield "robot", robot_lens_scene(res=64, device=device)
    yield "robot_refined", robot_lens_scene(res=48, refine=True, device=device)
    yield "robot_split4", robot_lens_scene(res=32, split=4, device=device)


def rows_for(scene, emitter_start, emitter_direction) -> dict:
    """One fixture's {"ortho": ..., "emitter": ...}, the JAX probe's keys."""
    rows = {}
    for tag, (s, d) in (("ortho", (scene.start, scene.direction)),
                        ("emitter", (emitter_start, emitter_direction))):
        w, wv, ww, wr, n = measure(scene, s, d)
        rows[tag] = {"need": round(w, 4), "votes": round(wv, 4), "winners": round(ww, 4),
                     "winners_ray": round(wr, 4), "candidates": n}
    return rows


def main(argv=None) -> int:
    from ..models.fit import emitter_rays

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    records.add_output_args(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = records.resolve_device(args.device)
    es, ed = emitter_rays(4096, belts=16, seed=1, device=dev)
    out = {}
    for name, scene in fixtures(dev):
        out[name] = rows_for(scene, es, ed)
        print(name, json.dumps(out[name]), flush=True)
        del scene
    result = {
        "max_inflation_needed_all_candidates": max(
            r["need"] for rows in out.values() for r in rows.values()),
        "max_winner_ray_sphere_requirement": max(
            r["winners_ray"] for rows in out.values() for r in rows.values()),
    }
    print("RESULT", json.dumps(result), flush=True)
    records.emit({"fixtures": out, **result, **records.card_fields(dev)}, args.out, args.label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
