"""The benchmark's general machinery: finding a cell's files by name, the
window's statistics, the profiler's reduction, the module check and the
result line.

Nothing here knows a configuration, a traffic mix or a metric by name.
A cell is ``workloads/<cell>.json``: its configuration's name (the sizes in
``configs/<config>.json``), its traffic (``traffic/<driver>.py`` and the
driver's parameters) and the limits of its correctness check.  A driver's
``Cell(cfg, traffic, seed, device)`` has ``warm()`` (the set-up's last
part), ``unit()`` (one unit of the window, returning its record),
``settle()`` (after the window: carry the work on to a state the check can
judge), ``free()``, ``check(seed)`` (the readings held to the limits), and
for ``calibrate.py`` ``drop()`` and ``control(seed)``.  A metric is
``metrics/<metric>.py``, a reader with ``read(ctx)`` that returns the
number or None when it finds nothing to read.  ``BENCHMARK.json`` at the
root says which metrics a cell reports.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# modules that may not be loaded in a run, by their top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "limbo_tpu")


# ---------------------------------------------------------------------------
# files found by name
# ---------------------------------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{path.parent.name}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(name: str, base: Path = HERE) -> dict:
    return load_json(base / "workloads" / f"{name}.json")


def config(name: str, base: Path = HERE) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def traffic_driver(name: str, base: Path = HERE):
    return load_module(base / "traffic" / f"{name}.py", name)


def metric_reader(name: str, base: Path = HERE):
    return load_module(base / "metrics" / f"{name}.py", name)


def load_cell(name: str, base: Path = HERE, overrides: dict | None = None):
    """(workload, configuration, traffic parameters, traffic driver) of
    cell ``name``; ``overrides`` replaces keys of the configuration
    ("config") and of the traffic's parameters ("traffic"), for runs at
    small sizes."""
    wl = workload(name, base)
    cfg = config(wl["config"], base)
    traffic = dict(wl["traffic"])
    for key, part in (("config", cfg), ("traffic", traffic)):
        part.update((overrides or {}).get(key, {}))
    return wl, cfg, traffic, traffic_driver(traffic["driver"], base)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a cell reports: with ``trace`` its per-layer metrics,
    else its end-to-end ones.  A metric with a ``workloads`` list belongs
    to the cells it lists; a per-layer metric without one belongs to every
    cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


# ---------------------------------------------------------------------------
# the window's statistics
# ---------------------------------------------------------------------------

def window_s(records: list, t_start: float) -> float:
    """From the window's start to the end of the last unit begun inside
    it: the window of a whole-window rate, stalls and all."""
    if not records:
        raise ValueError("no unit ran in the window")
    return records[-1]["end"] - t_start


def rate(records: list, t_start: float) -> float:
    """Units completed per second of the whole window."""
    return len(records) / window_s(records, t_start)


def seconds_per_unit(records: list, t_start: float) -> float:
    """The whole window's seconds per unit."""
    return window_s(records, t_start) / len(records)


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank: the smallest value with at least a
    share q of all values at or below it (the 99th percentile of 1,000
    values is the 990th smallest, with 10 beyond it)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = max(1, math.ceil(q * len(xs)))
    return xs[k - 1]


def spread(values) -> float:
    """The distance between the first and the third quartile as a share
    of the median (Python's ``statistics.quantiles``, n = 4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


# ---------------------------------------------------------------------------
# the process
# ---------------------------------------------------------------------------

def process_age_s() -> float:
    """Seconds since this process started, from its start time in
    /proc/self/stat (clock ticks since boot) against the boot clock; the
    time since the harness's first line where /proc is missing."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, IndexError, ValueError, AttributeError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is the JAX stack's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


# ---------------------------------------------------------------------------
# the profiler's reduction
# ---------------------------------------------------------------------------

def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in ns."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def gaps(intervals, lo: int, hi: int) -> list:
    """The idle (start, end) gaps in ns between the union of the intervals,
    inside [lo, hi]."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """What a profiled slice left: the device's kernels and copies and the
    host's operations as (name, start ns, end ns) on one clock, and the
    slice's host seconds."""

    def __init__(self, device_ops: list, host_ops: list, wall_s: float,
                 t0_ns: int, t1_ns: int):
        self.device_ops, self.host_ops = device_ops, host_ops
        self.wall_s, self.t0_ns, self.t1_ns = wall_s, t0_ns, t1_ns

    @classmethod
    def from_profiler(cls, prof, wall_s: float) -> "Trace":
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns()
            span = (e.name(), s, s + e.duration_ns())
            kind = str(e.device_type()).rsplit(".", 1)[-1]
            (dev if kind == "CUDA" else host).append(span)
        dev = [d for d in dev if d[2] > d[1]]
        starts = [s for _, s, _ in dev + host]
        ends = [e for _, _, e in dev + host]
        t0 = min(starts) if starts else 0
        t1 = max(ends) if ends else 0
        return cls(dev, host, wall_s, t0, t1)

    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.device_ops])

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.wall_s

    def breakdown(self, top: int = 10, short_ns: int = 10_000) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host operation running at each gap's
        middle, in seconds; gaps under ``short_ns`` (launch latency) are
        summed apart."""
        ops: dict = {}
        for n, s, e in self.device_ops:
            ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
        idle: dict = {}
        spans = [(s, e) for _, s, e in self.device_ops]
        host = sorted(self.host_ops, key=lambda h: h[1])
        starts = [h[1] for h in host]
        for s, e in gaps(spans, self.t0_ns, self.t1_ns):
            if e - s < short_ns:
                name = f"(gaps under {short_ns // 1000} us)"
            else:
                name = _innermost(host, starts, (s + e) // 2)
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e9

        def head(d):
            return [[k[:120], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(ops), "idle_gaps": head(idle)}


def _innermost(host: list, starts: list, t: int, depth: int = 256) -> str:
    """The host operation with the latest start that still runs at t (the
    innermost of nested ones), looking back at most ``depth`` starts."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - depth, -1), -1):
        if host[j][2] >= t:
            return host[j][0]
    return "(no host operation)"


def before_slice(records: list) -> list:
    """The window's units before the traced slice: the units after it run
    beside the trace's events, whose bulk slows the host's collector."""
    for i, r in enumerate(records):
        if r["traced"]:
            return records[:i]
    return []


def idle_share(trace, records) -> float | None:
    """The device's idle share of a unit, in %: 1 - the traced units'
    device-busy seconds a unit over the host seconds a unit of the units
    before the slice.  The kernels' times come from the trace, the unit's
    time from untraced units: the profiler slows the host's launches (a
    captured replay's ``cudaGraphLaunch`` by milliseconds), not the
    kernels."""
    traced = [r for r in records if r["traced"]]
    plain = before_slice(records)
    if trace is None or not trace.device_ops or not traced or not plain:
        return None
    busy = trace.busy_s() / len(traced)
    unit = sum(r["end"] - r["start"] for r in plain) / len(plain)
    return 100.0 * (1.0 - busy / unit)


def profile_slice(fn, sync):
    """Run ``fn`` under torch.profiler (host and device), synchronized at
    both ends; returns (fn's result, Trace)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    return out, Trace.from_profiler(prof, wall)


# ---------------------------------------------------------------------------
# the correctness check's verdict
# ---------------------------------------------------------------------------

def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, checks): every reading finite and at or below its limit;
    checks maps each name to its reading and limit.  A reading without a
    limit, or a limit without a reading, fails."""
    checks, ok = {}, True
    for name in sorted(set(readings) | set(limits)):
        v, lim = readings.get(name), limits.get(name)
        good = (v is not None and lim is not None
                and math.isfinite(v) and v <= lim)
        ok = ok and good
        checks[name] = {"value": v, "limit": lim}
    return ok, checks
