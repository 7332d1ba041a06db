#!/usr/bin/env python3
"""Where the time of one cached BO iteration of the PyTorch port goes, on
the card.

Builds chip_smoke.py's main path (its ``MainPath``: n = 10,000, d = 8,
capacity 10240, SquaredExpARD + DataMean, bf16 mirror, defer_m = 32,
RandomRestarts of Rprop(20) x 64 restarts + a 1024-point sweep maximizing
UCB, deferred appends), runs one warm-up iteration, then:

* times the acquisition and the append of each of ``--iters`` iterations
  with the host clock around work that ends in a synchronize;
* traces ``--trace-iters`` more iterations with torch.profiler and prints
  the device time by kernel, the device-busy total and the idle share of
  the traced wall time, and writes the Chrome trace to ``--trace`` if given.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/torch_iter_profile.py [--iters 10] [--trace-iters 3]
        [--trace out/trace.json]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trace-iters", type=int, default=3)
    ap.add_argument("--trace", type=Path, default=None,
                    help="write the Chrome trace of the traced iterations")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_iter_profile: CUDA is not available", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    from chip_smoke import MainPath, card_line
    from limbo_tpu_torch.ops import _cuda

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    _cuda.build_all()
    dev = torch.device("cuda", 0)
    path = MainPath(dev, torch.Generator(device=dev).manual_seed(args.seed))
    gp = path.fit()
    cache = path.build(gp)
    gp, cache = path.iterate(gp, cache)                       # warm-up
    torch.cuda.synchronize()
    t_acq, t_app = [], []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        x = path.acquire(gp, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gp, cache = path.append(gp, cache, x)
        torch.cuda.synchronize()
        t_acq.append(t1 - t0)
        t_app.append(time.perf_counter() - t1)
    print(f"per iteration over {args.iters}: acquisition "
          f"{1e3 * sum(t_acq) / len(t_acq):.3f} ms (min "
          f"{1e3 * min(t_acq):.3f}), append "
          f"{1e3 * sum(t_app) / len(t_app):.3f} ms (min "
          f"{1e3 * min(t_app):.3f}), host clock around synchronize",
          flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.trace_iters):
            gp, cache = path.iterate(gp, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (the kernels and copies themselves): an
    # operator's row would count its kernels' time a second time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    print(f"traced {args.trace_iters} iterations: wall {1e3 * wall:.3f} ms,"
          f" device busy {1e3 * busy:.3f} ms, idle share "
          f"{1.0 - busy / wall:.3f}")
    print("device time by kernel (ms per iteration, launches per "
          "iteration):")
    for key, us, count in rows[:20]:
        print(f"  {us / 1e3 / args.trace_iters:9.4f}  "
              f"{count / args.trace_iters:7.1f}  {key[:90]}")
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
