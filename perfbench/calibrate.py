#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card: the program's
on many seeds and the control's on a few, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ...
        [--control 3] [--units U] [--out FILE]

For each seed the cell is set up as a run sets it up, runs ``units`` units
of its traffic (by default, for a BO loop, every append the capacity holds,
the longest run the window's check can meet; one unit otherwise), settles
as a run does, and its check gives the program's readings.  For the first ``--control`` seeds the
program's state is then released and the control (the reference in TF32,
the mirror in float8: reference/control.py) gives its readings on the same
data.  One JSON line a seed on standard output (and appended to ``--out``);
the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def calibrate(name: str, seeds, n_control: int, units=None,
              device: str = "cuda", overrides: dict | None = None,
              out=None) -> list:
    import torch

    _, cfg, traffic, driver = harness.load_cell(name, overrides=overrides)
    if units is None:
        units = (cfg["capacity"] - cfg["n"] if traffic["driver"] == "bo_loop"
                 else 1)
    lines = []
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        cell = driver.Cell(cfg, traffic, seed, torch.device(device))
        cell.warm()
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(units):
            cell.unit()
        t_units = time.perf_counter() - t0
        cell.settle()
        cell.free()
        t0 = time.perf_counter()
        rec = {"workload": name, "seed": seed, "units": units,
               "program": cell.check(seed)}
        t_check = time.perf_counter() - t0
        if k < n_control:
            cell.drop()
            t0 = time.perf_counter()
            rec["control"] = cell.control(seed)
            rec["control_s"] = time.perf_counter() - t0
        rec.update(setup_s=t_setup, units_s=t_units, check_s=t_check,
                   diag=getattr(cell, "diag", None))
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(line + "\n")
        lines.append(rec)
        del cell
        if device != "cpu":
            torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    from limbo_tpu_torch.ops import _cuda
    _cuda.build_all()
    calibrate(args.workload, args.seeds, args.control, args.units,
              out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
