#!/usr/bin/env python3
"""Where the wall time of the n = 10k cached BO loop goes, on the card.

Runs chip_smoke.py's main path (its ``MainPath``: n = 10,000, d = 8, a bf16
mirror, defer_m = 32, RandomRestarts of Rprop(20) x 64 restarts + a
1024-point sweep on UCB, deferred appends) from the checkout at ``--tree``
(default: this one), so that two checkouts can be compared on one card,
one process each.  After the fit, the cache build and one warm-up
iteration:

* ``--rounds`` rounds of ``--iters`` iterations, each timed as chip_smoke.py
  times its loop (host clock, one synchronize at the end): iters/s, the
  host time spent in ``acquire`` and ``append`` before that synchronize,
  the time the synchronize waited (the device's backlog), and the host time
  inside the mirror wrapper (``ops/mirror.mirror_mm``, as ``models/gp.py``
  calls it); then one round with a synchronize after each ``acquire`` and
  each ``append``, as scripts/torch_iter_profile.py times them;
* the card's SM clock, power draw and utilization, sampled by
  ``nvidia-smi`` every 50 ms over the rounds;
* five more iterations under ``torch.cuda.set_sync_debug_mode("warn")``:
  the calls per iteration that made the host wait for the card.

With ``--pad-us U`` each mirror call also queues a spin kernel of about U
microseconds (``torch.cuda._sleep``) after the product: device time added
at the cost of one launch, which tells a host cost from an idle card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/torch_loop_host.py [--tree DIR] [--pad-us 0]
        [--rounds 3] [--iters 40]

Prints a few lines and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path


def sampler() -> subprocess.Popen:
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def samples(proc: subprocess.Popen) -> dict:
    """Stop the sampler; the median and range of each quantity."""
    proc.terminate()
    out, _ = proc.communicate()
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    res = {"samples": len(rows)}
    for i, k in enumerate(("sm_mhz", "power_w", "util_pct")):
        col = [r[i] for r in rows]
        if col:
            res[k] = dict(median=statistics.median(col), min=min(col),
                          max=max(col))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--pad-us", type=float, default=0.0)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_loop_host: CUDA is not available", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    import chip_smoke as cs
    from limbo_tpu_torch.models import gp as gp_mod
    from limbo_tpu_torch.ops import _cuda

    card = cs.card_line()
    _cuda.build_all()
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    pad_cycles = int(args.pad_us * max_mhz)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    path = cs.MainPath(dev, gen)
    gp = path.fit()
    cache = path.build(gp)
    gp, cache = path.iterate(gp, cache)                       # warm-up
    torch.cuda.synchronize()

    host = {"s": 0.0, "calls": 0}
    product = gp_mod.mirror_mm

    def timed_mirror(ks, Kq):
        t0 = time.perf_counter()
        out = product(ks, Kq)
        if pad_cycles:
            torch.cuda._sleep(pad_cycles)
        host["s"] += time.perf_counter() - t0
        host["calls"] += 1
        return out

    gp_mod.mirror_mm = timed_mirror
    rounds = []
    smi = sampler()
    for r in range(args.rounds + 1):
        synced = r == args.rounds
        host.update(s=0.0, calls=0)
        t_acq = t_app = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            a = time.perf_counter()
            x = path.acquire(gp, cache)
            if synced:
                torch.cuda.synchronize()
            b = time.perf_counter()
            gp, cache = path.append(gp, cache, x)
            if synced:
                torch.cuda.synchronize()
            t_acq += b - a
            t_app += time.perf_counter() - b
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = args.iters
        rounds.append(dict(
            synced=float(synced), iters_per_s=n / wall,
            acquire_ms=1e3 * t_acq / n, append_ms=1e3 * t_app / n,
            backlog_ms=1e3 * (wall - t_host),
            mirror_host_ms=1e3 * host["s"] / n,
            mirror_host_us_per_call=1e6 * host["s"] / max(host["calls"], 1),
            mirror_calls=host["calls"] / n))
    card_samples = samples(smi)

    reps = 5
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(reps):
                gp, cache = path.iterate(gp, cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    waits = sorted({str(w.message).splitlines()[0][:100] for w in caught})

    print(f"card: {card}; tree {args.tree}; pad {args.pad_us} us")
    for r in rounds:
        print("  " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()))
    print(f"  card over the rounds: {card_samples}")
    print(f"  host waits per iteration: {len(caught) / reps:.1f} {waits}")
    print(json.dumps({"loop_host": dict(
        tree=str(args.tree), pad_us=args.pad_us, rounds=rounds,
        card_samples=card_samples, syncs_per_iter=len(caught) / reps,
        sync_kinds=waits, card=card)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
