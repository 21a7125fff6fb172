"""Set a cell's limits (`limits/<workload>.json`) from calibration outputs
(`calibrate.py --out`), by one rule for every number:

* lower: the largest reading of the sound program;
* upper: the smallest reading of a control (`control`, `control_build`) that
  is three times the lower or more; in a fit cell also of a fault that reads
  ten times the lower or more (`unchanged`, a state left unchanged: three
  times);
* limit: lower x (upper / lower) ** 0.6, to three significant figures, more
  room above the lower than below the upper; 0 where every sound reading is
  0 (an exact comparison, as the render's `rerun`).

    python -m portbench.set_limits --workload <name> --measured "<text>" OUT.json [...]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

CONTROLS = ("control", "control_build")
FIT_FAULTS = {"unchanged": 3.0, "half_batch": 10.0, "altered": 10.0}
RULE = ("lower: the largest sound reading; upper: the smallest control reading at 3x the lower "
        "or more (fit cells: also a fault at 10x, unchanged at 3x); "
        "limit = lower x (upper/lower)^0.6")


def _sig3(x: float) -> float:
    return float(f"{x:.3g}")


def limit_of(readings: dict, fit: bool) -> dict:
    """readings: plant -> list of values of one number."""
    lower = max(readings["program"])
    if lower == 0.0:
        return {"limit": 0.0, "lower": 0.0, "upper": None, "upper_from": "exact"}
    candidates = []
    for plant, values in readings.items():
        least = min(values)
        factor = 3.0 if plant in CONTROLS else FIT_FAULTS.get(plant) if fit else None
        if factor is not None and least >= factor * lower:
            candidates.append((least, plant))
    if not candidates:
        return {"limit": None, "lower": lower, "upper": None, "upper_from": None}
    upper, source = min(candidates)
    return {"limit": _sig3(lower * (upper / lower) ** 0.6), "lower": lower, "upper": upper,
            "upper_from": source}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--measured", required=True)
    ap.add_argument("outputs", nargs="+")
    args = ap.parse_args(argv)

    from . import cell as cells

    c = cells.find_cell(cells.load_benchmark(), args.workload)
    fit = c.traffic["driver"] == "fit"
    rows = [r for path in args.outputs for r in json.load(open(path))["rows"]]
    by_number = {}
    for r in rows:
        for k, v in r.get("numbers", {}).items():
            by_number.setdefault(k, {}).setdefault(r["plant"], []).append(v)
    numbers = {}
    for name, readings in sorted(by_number.items()):
        entry = limit_of(readings, fit)
        entry["readings"] = {p: {"min": min(v), "max": max(v), "runs": len(v)}
                             for p, v in readings.items()}
        numbers[name] = entry
        if entry["limit"] is None:
            print(f"{name}: no control or fault separates it: {entry['readings']}",
                  file=sys.stderr)
    path = os.path.join(c.package_dir, "limits", f"{args.workload}.json")
    with open(path, "w") as f:
        json.dump({"measured": args.measured, "rule": RULE, "numbers": numbers}, f, indent=1)
        f.write("\n")
    for name, e in numbers.items():
        print(f"{name}: lower {e['lower']!r} upper {e['upper']!r} ({e['upper_from']}) "
              f"limit {e['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
