"""Regenerate the port's table in PERF.md from the port's committed records.

Counterpart of benchmarks/gen_perf_table.py.  It reads only JSON records in
torch_artifacts/: the bench's (`BENCH_*.json`: a run of `python -m
cbtr_tpu_torch.bench` wrapped as the repository's BENCH_r*.json records
are, {"cmd", "rc", "tail", "parsed"}, or the bench's record itself) and the latest `RENDER4K_*.json`,
`TRAIN4K_*.json` and `EMITTER4K_*.json` (`render4k`, `train4k`,
`emitter4k`), and writes the table between the PORT-BENCH markers of
PERF.md, and nowhere else: the TPU record's BENCH block belongs to
benchmarks/gen_perf_table.py.

A record whose "parsed" is null, or whose line the tail cut, is salvaged:
every complete value whose key stands at the top level of the tail's last
object is read back, and every cell it cannot fill prints "—".

    python -m cbtr_tpu_torch.benchmarks.gen_perf_table [--check]
    python -m cbtr_tpu_torch.benchmarks.gen_perf_table --wrap LOG --cmd CMD
        --out torch_artifacts/BENCH_<label>.json [--label TEXT]

--check exits 1 when the table in PERF.md is stale.  --wrap writes a bench
log's last 2000 characters as such a wrapped record ({"cmd", "rc", "tail",
"parsed"}: parsed is the last line's JSON, or null where it does not parse).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARTIFACTS = os.path.join(REPO, "torch_artifacts")
PERF = os.path.join(REPO, "PERF.md")
BEGIN = ("<!-- PORT-BENCH:BEGIN (generated by python -m "
         "cbtr_tpu_torch.benchmarks.gen_perf_table) -->")
END = "<!-- PORT-BENCH:END -->"
TAIL_CHARS = 2000
_KEY = re.compile(r'"((?:[^"\\]|\\.)*)"\s*:\s*')


def _depth_from_end(text: str, pos: int) -> int:
    """Unclosed '}' after `pos` (outside strings): 1 for a key of the object
    that ends the text."""
    depth, in_str, escaped = 0, False, False
    for ch in text[pos:]:
        if in_str:
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch == "}":
            depth += 1
        elif ch == "{":
            depth -= 1
    return depth


def salvage(tail: str) -> dict:
    """The top-level values a cut JSON line still holds: each key at the
    outermost level of the object that ends `tail` whose value decodes
    whole (objects included); nothing where the line's end is cut too."""
    text = tail.rstrip()
    if not text.endswith("}"):
        return {}
    decoder = json.JSONDecoder()
    out = {}
    for m in _KEY.finditer(text):
        if _depth_from_end(text, m.start()) != 1:
            continue
        try:
            value, _ = decoder.raw_decode(text, m.end())
        except ValueError:
            continue
        out.setdefault(m.group(1), value)
    return out


def load_record(path: str) -> dict:
    """A record as a dict: the bench's own JSON, a wrapped record's "parsed",
    or what `salvage` reads from its tail (with "salvaged": true)."""
    with open(path) as f:
        rec = json.load(f)
    if "parsed" not in rec and "tail" not in rec:
        return rec
    if isinstance(rec.get("parsed"), dict):
        return rec["parsed"]
    return {**salvage(rec.get("tail") or ""), "salvaged": True}


def _get(rec, *keys):
    for k in keys:
        rec = rec.get(k) if isinstance(rec, dict) else None
    return rec


def _num(v, fmt="{:,.0f}"):
    return fmt.format(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else "—"


BENCH_ROWS = (
    ("rays/s fwd+bwd, robot 512×512 (headline)", ("value",), "{:,.0f}"),
    ("robot 1024×1024 (BASELINE config 3), rays/s", ("robot_1024", "rays_per_s"), "{:,.0f}"),
    ("ellipsoid 512×512 (BASELINE config 2), rays/s", ("ellipsoid_512", "rays_per_s"),
     "{:,.0f}"),
    ("robot refined, P=1800 (intersect only), rays/s",
     ("robot_refined", "intersect_rays_per_s"), "{:,.0f}"),
    ("robot split=4, P=7200 (intersect only), rays/s",
     ("robot_split4", "intersect_rays_per_s"), "{:,.0f}"),
    ("robot split=6, P=16200 (intersect only), rays/s",
     ("robot_split6", "intersect_rays_per_s"), "{:,.0f}"),
    ("kernel vs plain twin agreement", ("kernel_plain_agreement",), "{:.5f}"),
    ("FP32 FMA peak, TFLOP/s (K4)", ("fma_peak_tflops",), "{:.3f}"),
)


def _records(artifacts: str, stem: str) -> list:
    """The records `<stem>_*.json` in PR order: by the number at the end of
    the name (pr9 before pr10), then by name."""
    def order(path):
        name = os.path.splitext(os.path.basename(path))[0]
        digits = re.search(r"(\d+)$", name)
        return (int(digits.group(1)) if digits else -1, name)

    return sorted(glob.glob(os.path.join(artifacts, f"{stem}_*.json")), key=order)


def build_table(artifacts: str = ARTIFACTS) -> str:
    benches = []
    for path in _records(artifacts, "BENCH"):
        name = os.path.splitext(os.path.basename(path))[0][len("BENCH_"):]
        benches.append((name, load_record(path)))
    lines = []
    if benches:
        lines.append("| metric | " + " | ".join(n for n, _ in benches) + " |")
        lines.append("|---|" + "---|" * len(benches))
        lines.append("| card | " + " | ".join(str(r.get("card") or "—") for _, r in benches)
                     + " |")
        for label, keys, fmt in BENCH_ROWS:
            lines.append(f"| {label} | "
                         + " | ".join(_num(_get(r, *keys), fmt) for _, r in benches) + " |")
    big = []
    for stem, label in (("RENDER4K", "4K render (16.8M rays, fwd)"),
                        ("TRAIN4K", "4K train step (16.8M rays, fwd+bwd)"),
                        ("EMITTER4K", "16.8M-ray device-emitter render (point source, fwd)")):
        paths = _records(artifacts, stem)
        if not paths:
            continue
        rec = load_record(paths[-1])
        flat = rec.get("device_path", rec)
        rate = flat.get("rays_per_s", flat.get("rays_per_s_fwd_bwd"))
        peak = flat.get("peak_memory_gib", rec.get("peak_memory_gib"))
        big.append(f"| {label} | {_num(rate)} rays/s, {_num(flat.get('wall_s'), '{}')} s wall, "
                   f"peak {_num(peak, '{:.2f}')} GiB, chunk {_num(rec.get('chunk'))} | "
                   f"{rec.get('card') or '—'} | {os.path.basename(paths[-1])} |")
    if big:
        lines += ["", "| large-scale record (latest) | result | card | file |",
                  "|---|---|---|---|"] + big
    return "\n".join(lines)


def regenerate(perf: str = PERF, artifacts: str = ARTIFACTS, check: bool = False) -> bool:
    """Rewrite the table between the markers of `perf` (check: only compare).
    Returns whether the file was up to date; raises if a marker is missing."""
    with open(perf) as f:
        doc = f.read()
    if BEGIN not in doc or END not in doc:
        raise ValueError(f"the PORT-BENCH markers are not in {perf}")
    pre, rest = doc.split(BEGIN, 1)
    _, post = rest.split(END, 1)
    new = pre + BEGIN + "\n" + build_table(artifacts) + "\n" + END + post
    if not check and new != doc:
        with open(perf, "w") as f:
            f.write(new)
    return new == doc


def wrap(log: str, cmd: str, rc: int = 0, label: str = "") -> dict:
    """A wrapped record of a run's standard output (module docstring)."""
    with open(log) as f:
        text = f.read()
    lines = text.strip().splitlines()
    try:
        parsed = json.loads(lines[-1]) if lines else None
    except ValueError:
        parsed = None
    rec = {"cmd": cmd, "rc": rc, "tail": text[-TAIL_CHARS:],
           "parsed": parsed if isinstance(parsed, dict) else None}
    if label:
        rec["label"] = label
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if PERF.md's table is stale instead of rewriting it")
    ap.add_argument("--wrap", default="", help="a bench log to wrap as a record")
    ap.add_argument("--cmd", default="python -m cbtr_tpu_torch.bench --preset full")
    ap.add_argument("--rc", type=int, default=0)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--perf", default=PERF)
    ap.add_argument("--artifacts", default=ARTIFACTS)
    args = ap.parse_args(argv)
    if args.wrap:
        rec = wrap(args.wrap, args.cmd, args.rc, args.label)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
        print(json.dumps({"wrapped": args.wrap, "out": args.out,
                          "parsed": rec["parsed"] is not None}))
        return 0
    fresh = regenerate(args.perf, args.artifacts, check=args.check)
    if args.check and not fresh:
        print(f"{args.perf}: the port's table is stale; run python -m "
              "cbtr_tpu_torch.benchmarks.gen_perf_table", file=sys.stderr)
        return 1
    print(f"{args.perf}: the port's table is "
          f"{'up to date' if fresh else 'regenerated'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
