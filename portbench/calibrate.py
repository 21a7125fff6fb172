"""Read a cell's compared numbers over many seeds in one process: the
program as it stands, and the program with the control or a fault planted
(`faults.py`).  The limits of `limits/<workload>.json` are set from these
readings (the largest of the sound runs, the smallest of the control's).

    python -m portbench.calibrate --workload <name> --seeds 1,2,3
        [--plant program,control,half_batch] [--seconds 1] [--out FILE] [--look]

Each run is a whole `run.run_cell` on the card at the cell's own size,
with a short window.  Prints one JSON line per run, then a summary: each
number's largest reading for each plant and its smallest.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--plant", default="program,control",
                    help="comma-separated: program and any of faults.FAULTS")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--look", action="store_true",
                    help="fit cells: also trace the reference on the program's own tables "
                         "in the program's runs")
    args = ap.parse_args(argv)

    from . import cell as cells
    from . import faults, run

    c = cells.find_cell(cells.load_benchmark(), args.workload)
    run.pin_caches(c.root)
    rows = []
    for plant in args.plant.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            ctx = contextlib.nullcontext() if plant == "program" else faults.FAULTS[plant]()
            if hasattr(c.driver.State, "look"):
                c.driver.State.look = args.look and plant == "program"
            t = time.perf_counter()
            try:
                with ctx:
                    r = run.run_cell(c, seed, args.seconds, False, t0=t)
                numbers = {k: v["value"] for k, v in r["checks"].items()}
                row = {"plant": plant, "seed": seed, "numbers": numbers,
                       "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                       "readings": r["readings"],
                       "peak": r["device"]["memory_peak_bytes"], "check_s": r["check_s"]}
            except Exception as e:  # a plant that crashes gives no number
                row = {"plant": plant, "seed": seed, "error": repr(e)}
            row["s"] = time.perf_counter() - t
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for row in rows:
        for k, v in {**row.get("numbers", {}), **row.get("readings", {})}.items():
            s = summary.setdefault(row["plant"], {}).setdefault(k, [])
            s.append(v)
    summary = {p: {k: {"min": min(v), "max": max(v), "n": len(v)} for k, v in d.items()}
               for p, d in summary.items()}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
