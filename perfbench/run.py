#!/usr/bin/env python3
"""The benchmark of ``limbo_tpu_torch`` on NVIDIA cards: one run of one
cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell is ``perfbench/workloads/<cell>.json``
(its configuration, its traffic driver and parameters, the limits of its
check); ``BENCHMARK.json`` says which metrics it reports.  A run:

1. makes the data and the program's state on the card from ``--seed`` and
   warms every shape the cell's traffic uses (the set-up, ``setup_s``);
2. runs the traffic's units back to back for ``--seconds`` (a unit begun
   inside the window runs to its end); with ``--trace 1`` a steady slice of
   the window runs under torch.profiler, and the run reports the cell's
   per-layer metrics instead of its end-to-end ones;
3. reads the device's peak memory, lets the traffic carry its last unit of
   work on to a state the check can judge (``settle``: a BO run past its
   first flush), releases what the check does not read, and compares what
   the timed path produced with the float64 reference of
   ``perfbench/reference`` (``correct``), each number beside its limit;
4. fails, printing no result, if a module of the JAX stack or the JAX
   package was loaded;
5. prints the numbers compared on standard error, then one JSON line on
   standard output.

A run without a CUDA card, or with fewer cards than the cell asks for,
exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


class Context:
    """What a metric's reader reads: the configuration and traffic, the
    window's unit records (start, end and the traffic's own fields), the
    window's start, the set-up seconds, the traced slice (a harness.Trace,
    or None) and the records of the units inside it."""

    def __init__(self, cfg, traffic, records, t_start, setup_s, trace,
                 traced):
        self.cfg, self.traffic, self.records = cfg, traffic, records
        self.t_start, self.setup_s = t_start, setup_s
        self.trace, self.traced = trace, traced


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def host_line() -> str:
    """Where the window ran: the CPU the process was last on, the CPUs it
    may use, and the card's clocks, temperature and power (nvidia-smi)."""
    try:
        with open("/proc/self/stat") as fh:
            cpu = fh.read().rsplit(")", 1)[1].split()[36]
    except (OSError, IndexError):
        cpu = "?"
    try:
        allowed = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        allowed = "?"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
             "power.draw", "--format=csv,noheader"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return f"cpu {cpu} of {allowed}; card {out}"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", base: Path = harness.HERE,
             root: Path = harness.ROOT, overrides: dict | None = None
             ) -> dict:
    """One run of cell ``name``; returns the result line's object, with
    the numbers compared under "checks".  ``overrides`` replaces keys of
    the configuration and of the traffic (harness.load_cell)."""
    import torch

    bench = harness.benchmark(root)
    if name not in {w["name"] for w in bench["workloads"]}:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    wl, cfg, traffic, driver = harness.load_cell(name, base, overrides)
    metrics = harness.cell_metrics(bench, name, trace)
    readers = {m["name"]: harness.metric_reader(m["name"], base)
               for m in metrics}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        from limbo_tpu_torch.ops import _cuda
        log(f"kernel build {_cuda.build_all():.1f} s")

    cell = driver.Cell(cfg, traffic, seed, dev)
    cell.warm()
    setup_s = harness.process_age_s()
    log(f"set-up {setup_s:.3f} s")

    records, traced, tr = [], [], None

    def timed_unit(mark=False):
        s = time.perf_counter()
        rec = cell.unit()
        rec.update(start=s, end=time.perf_counter(), traced=mark)
        return rec

    t_start = time.perf_counter()
    deadline = t_start + seconds
    while time.perf_counter() < deadline:
        if trace and tr is None and len(records) >= cell.trace_after:
            traced, tr = harness.profile_slice(
                lambda: [timed_unit(True) for _ in range(cell.trace_units)],
                cell.sync)
            records.extend(traced)
            continue
        records.append(timed_unit())
    med = {k: statistics.median(r[k] for r in records)
           for k in ("latency", "device_s")
           if all(r.get(k) is not None for r in records)}
    log(f"window: {len(records)} units in "
        f"{harness.window_s(records, t_start):.3f} s; medians {med}; "
        f"{host_line()}")

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    ctx = Context(cfg, traffic, records, t_start, setup_s, tr, traced)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    cell.settle()
    cell.free()
    t0 = time.perf_counter()
    readings = cell.check(seed)
    log(f"reference check {time.perf_counter() - t0:.3f} s")
    failed = sum(1 for r in records if r.get("failed"))
    correct, checks = harness.verdict(readings, wl["limits"])
    correct = correct and failed == 0
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": values}
    if cuda:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(dev),
                            "count": 1, "memory_peak_bytes": int(peak)}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.wall_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = harness.benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available():
        log("no CUDA card: this benchmark measures the port on the card")
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        log(f"{torch.cuda.device_count()} CUDA cards, the cell asks for "
            f"{chips[args.workload]}")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        log(f"modules of the JAX stack or the JAX package were loaded: "
            f"{bad}")
        return 3
    for k, c in res["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    log(f"correct: {res['correct']}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
