#!/usr/bin/env python3
"""The BO benchmark suite of the PyTorch port on the card, and its
comparison with the reference's recorded results.

    python3 scripts/torch_bo_suite.py [--variants V ...] [--functions F ...]
        [--out benchmark_results_torch] [--deadline S]
    python3 scripts/torch_bo_suite.py --compare [--out DIR] [--markdown F]

The first form runs limbo_tpu_torch.benchmarks.bo_suite.run_suite (the
reference's protocol: 10 random init points, 190 iterations, f32, through
optimize_jit) over the chosen variants (default: all 7) and functions
(default: all 8), 10 replicates one at a time, resuming from the .dat files in
--out, and stops starting replicates after --deadline seconds, so a long
protocol spreads over several calls.  Each call appends the card's name and
power limit to <out>/cards.txt.

--compare reads the reference's .dat files (benchmark_results/) and the
port's, and prints for each (variant, function)
both median accuracies, a two-sided Mann-Whitney U p-value over the
replicates, and the port's median time_ms beside the card; then one JSON
line of the same rows (and, with --markdown PATH, the same as one markdown
table: the port's median / the reference's, the p-value, the port's
median time).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

REPS = 10                       # replicates of each (variant, function)
REF = "benchmark_results"       # the reference's records


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def run(args) -> int:
    import torch

    from limbo_tpu_torch.benchmarks import bo_suite
    from limbo_tpu_torch.benchmarks.functions import ALL_FUNCTIONS

    if not torch.cuda.is_available():
        print("torch_bo_suite: CUDA is not available", file=sys.stderr)
        return 1
    import limbo_tpu_torch.ops._cuda as _cuda

    card = card_line()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "cards.txt"), "a") as fh:
        fh.write(card + "\n")
    print(f"card: {card}; build {_cuda.build_all():.1f} s", flush=True)
    variants = [v for v in bo_suite.default_variants()
                if not args.variants or v.name in args.variants]
    functions = [f for f in ALL_FUNCTIONS
                 if not args.functions or f.name in args.functions]
    t0 = time.perf_counter()
    failed = []
    for v in variants:
        for fn in functions:
            try:
                for rep in range(REPS):
                    if time.perf_counter() - t0 > args.deadline:
                        print(f"deadline: stopped at {v.name}/{fn.name} "
                              f"replicate {rep}", flush=True)
                        return 1 if failed else 0
                    bo_suite.run_suite([v], [fn], nb_reps=rep + 1,
                                       out_dir=args.out, verbose=False)
            except RuntimeError:
                # a failed run is reported and the pair left; the others go on
                traceback.print_exc()
                failed.append(f"{v.name}/{fn.name}")
                print(f"FAILED {v.name}/{fn.name}", flush=True)
                continue
            rows = np.loadtxt(os.path.join(args.out, v.name,
                                           fn.name + ".dat"), ndmin=2)
            print(f"{v.name:16s} {fn.name:16s} {rows.shape[0]} reps: "
                  f"accuracy median {np.median(rows[:, 0]):.6g}, time_ms "
                  f"median {np.median(rows[:, 1]):.1f} ({card}); "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    if failed:
        print(f"failed pairs: {failed}", flush=True)
    return 1 if failed else 0


def _dat(path):
    return np.loadtxt(path, ndmin=2) if os.path.exists(path) else None


def compare(args) -> int:
    from scipy.stats import mannwhitneyu

    cards_path = os.path.join(args.out, "cards.txt")
    cards = (sorted(set(open(cards_path).read().split("\n")) - {""})
             if os.path.exists(cards_path) else [])
    print(f"port's times on: {'; '.join(cards) or 'unknown'}")
    rows = []
    for v in sorted(os.listdir(args.out)):
        vdir = os.path.join(args.out, v)
        if not os.path.isdir(vdir):
            continue
        for f in sorted(os.listdir(vdir)):
            if not f.endswith(".dat"):
                continue
            port = _dat(os.path.join(vdir, f))
            ref = _dat(os.path.join(REF, v, f))
            row = dict(variant=v, function=f[:-4], n_port=int(port.shape[0]),
                       port_acc=float(np.median(port[:, 0])),
                       port_time_ms=float(np.median(port[:, 1])))
            if ref is not None:
                p = mannwhitneyu(ref[:, 0], port[:, 0],
                                 alternative="two-sided").pvalue
                row.update(n_ref=int(ref.shape[0]),
                           ref_acc=float(np.median(ref[:, 0])), p=float(p))
            rows.append(row)
            print(f"{v:16s} {f[:-4]:16s} port {row['port_acc']:.4g} "
                  f"(n={row['n_port']}) ref {row.get('ref_acc', np.nan):.4g}"
                  f" (n={row.get('n_ref', 0)}) p={row.get('p', np.nan):.3g}"
                  f"{' <0.01' if row.get('p', 1) < 0.01 else ''}  time "
                  f"{row['port_time_ms']:.1f} ms")
    print(json.dumps({"bo_suite_compare": rows, "cards": cards}))
    if args.markdown:
        with open(args.markdown, "w") as fh:
            fh.write(markdown(rows, "variant", "function", _acc_cell))
    return 0


def _vs_ref(r, key) -> str:
    """'reference median, p <p>' (bold ! under 0.01), or 'no ref'."""
    if "p" not in r:
        return "no ref"
    flag = " **!**" if r["p"] < 0.01 else ""
    return f"{r[key]:.3g}, p {r['p']:.2g}{flag}"


def _acc_cell(r):
    return (f"{r['port_acc']:.3g} / {_vs_ref(r, 'ref_acc')}; "
            f"{r['port_time_ms']:.0f} ms")


def markdown(rows, row_key, col_key, cell) -> str:
    """The compared rows as one markdown table, row_key down and col_key
    across."""
    rk = sorted({r[row_key] for r in rows})
    ck = sorted({r[col_key] for r in rows})
    at = {(r[row_key], r[col_key]): r for r in rows}
    out = ["| | " + " | ".join(ck) + " |", "|---" * (len(ck) + 1) + "|"]
    for a in rk:
        out.append(f"| {a} | " + " | ".join(
            cell(at[a, b]) if (a, b) in at else "" for b in ck) + " |")
    return "\n".join(out) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=None)
    ap.add_argument("--functions", nargs="*", default=None)
    ap.add_argument("--out", default="benchmark_results_torch")
    ap.add_argument("--deadline", type=float, default=float("inf"),
                    help="seconds after which no replicate is started")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--markdown", default=None,
                    help="with --compare: also write the tables here")
    args = ap.parse_args()
    return compare(args) if args.compare else run(args)


if __name__ == "__main__":
    sys.exit(main())
