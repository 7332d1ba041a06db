#!/usr/bin/env python3
"""The GP regression benchmark suite of the PyTorch port on the card, and
its comparison with the reference's recorded results.

    python3 scripts/torch_regression_suite.py [--functions F ...]
        [--out regression_results_torch] [--deadline S]
    python3 scripts/torch_regression_suite.py --compare [--out DIR]
        [--markdown F]

The first form runs limbo_tpu_torch.benchmarks.regression_suite as
scripts/run_regression_full.py ran the reference: the first dim of each of
the 8 functions (default: all), n in {50, 100, 200, 400, 600}, both
models, 10 replicates and 3 oracle replicates, f32 data with precise=True.  It goes one tag
(function, dim, n, model) at a time, resuming from the .dat files in
--out, and starts no tag after --deadline seconds.  Each call appends the
card's name and power limit to <out>/cards.txt.

--compare reads the reference's .dat files (regression_results/) and the
port's, and prints for each tag both median
MSEs, the oracle's, a two-sided Mann-Whitney U p-value over the replicates,
and the port's median learn_ms and query_ms beside the card; then one JSON
line of the same rows (and, with --markdown PATH, the same as one markdown
table: the port's median MSE / the reference's, the p-value, the port's
oracle's, then the port's learn / query times).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scripts.torch_bo_suite import (  # noqa: E402
    REPS, _dat, _vs_ref, card_line, markdown)

POINTS = (50, 100, 200, 400, 600)       # waf_tools/regression_benchmarks
ORACLE_REPS = 3                         # oracle replicates of each tag
REF = "regression_results"              # the reference's records


def run(args) -> int:
    import torch

    from limbo_tpu_torch.benchmarks import regression_suite as rs
    from limbo_tpu_torch.benchmarks.regression_functions import ALL_REGRESSION

    if not torch.cuda.is_available():
        print("torch_regression_suite: CUDA is not available",
              file=sys.stderr)
        return 1
    import limbo_tpu_torch.ops._cuda as _cuda

    card = card_line()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "cards.txt"), "a") as fh:
        fh.write(card + "\n")
    print(f"card: {card}; build {_cuda.build_all():.1f} s", flush=True)
    fns = [dataclasses.replace(f, dims=f.dims[:1]) for f in ALL_REGRESSION
           if not args.functions or f.name in args.functions]
    t0 = time.perf_counter()
    failed = []
    for fn in fns:
        for n in POINTS:
            for spec in rs.DEFAULT_MODELS:
                if time.perf_counter() - t0 > args.deadline:
                    print(f"deadline: stopped before {fn.name} n={n} "
                          f"{spec.name}", flush=True)
                    return 1 if failed else 0
                try:
                    rs.run_regression_suite(
                        functions=[fn], models=[spec], points=(n,),
                        nb_reps=REPS, out_dir=args.out,
                        dtype=torch.float32, with_oracle=True,
                        oracle_reps=ORACLE_REPS, verbose=True,
                        precise=True)
                except RuntimeError:
                    # a failed tag is reported and left; the others go on
                    traceback.print_exc()
                    failed.append(f"{fn.name} n={n} {spec.name}")
                    print(f"FAILED {failed[-1]}", flush=True)
                print(f"  ({card}; {time.perf_counter() - t0:.0f} s)",
                      flush=True)
    if failed:
        print(f"failed tags: {failed}", flush=True)
    return 1 if failed else 0


def compare(args) -> int:
    from scipy.stats import mannwhitneyu

    cards_path = os.path.join(args.out, "cards.txt")
    cards = (sorted(set(open(cards_path).read().split("\n")) - {""})
             if os.path.exists(cards_path) else [])
    print(f"port's times on: {'; '.join(cards) or 'unknown'}")
    rows = []
    for f in sorted(os.listdir(args.out)):
        if not f.endswith(".dat") or f.endswith(".oracle.dat"):
            continue
        tag = f[:-4]
        port = _dat(os.path.join(args.out, f))
        ref = _dat(os.path.join(REF, f))
        pora = _dat(os.path.join(args.out, tag + ".oracle.dat"))
        row = dict(tag=tag, n_port=int(port.shape[0]),
                   port_mse=float(np.median(port[:, 0])),
                   learn_ms=float(np.median(port[:, 1])),
                   query_ms=float(np.median(port[:, 2])))
        if pora is not None:
            row["oracle_mse"] = float(np.median(pora[:, 0]))
        if ref is not None:
            p = mannwhitneyu(ref[:, 0], port[:, 0],
                             alternative="two-sided").pvalue
            row.update(n_ref=int(ref.shape[0]),
                       ref_mse=float(np.median(ref[:, 0])), p=float(p))
        rows.append(row)
        print(f"{tag:48s} port {row['port_mse']:.4g} (n={row['n_port']}) "
              f"ref {row.get('ref_mse', np.nan):.4g} "
              f"(n={row.get('n_ref', 0)}) oracle "
              f"{row.get('oracle_mse', np.nan):.4g} "
              f"p={row.get('p', np.nan):.3g}"
              f"{' <0.01' if row.get('p', 1) < 0.01 else ''}  learn "
              f"{row['learn_ms']:.1f} ms query {row['query_ms']:.2f} ms")
    print(json.dumps({"regression_suite_compare": rows, "cards": cards}))
    if args.markdown:
        for r in rows:                  # Function_dD_nN_Model
            fn, dim, n, model = r["tag"].split("_", 3)
            r["row"], r["n"] = f"{fn} {dim} {model}", f"n={n[1:]:>3}"
        with open(args.markdown, "w") as fh:
            fh.write(markdown(rows, "row", "n", _mse_cell))
    return 0


def _mse_cell(r):
    oracle = r.get("oracle_mse", float("nan"))
    return (f"{r['port_mse']:.3g} / {_vs_ref(r, 'ref_mse')} ({oracle:.3g}); "
            f"{r['learn_ms']:.0f} / {r['query_ms']:.1f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--functions", nargs="*", default=None)
    ap.add_argument("--out", default="regression_results_torch")
    ap.add_argument("--deadline", type=float, default=float("inf"),
                    help="seconds after which no tag is started")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--markdown", default=None,
                    help="with --compare: also write the tables here")
    args = ap.parse_args()
    return compare(args) if args.compare else run(args)


if __name__ == "__main__":
    sys.exit(main())
