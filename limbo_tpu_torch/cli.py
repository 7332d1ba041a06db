"""Command-line interface of the port (limbo's waf experiment commands;
port of limbo_tpu/cli.py).

    python -m limbo_tpu_torch.cli create --name myexp [--dim_in 2 ...]
                                         [--device cuda]
    python -m limbo_tpu_torch.cli run-local exp/myexp/conf.json [--parallel N]
    python -m limbo_tpu_torch.cli gen-jobs exp/myexp/conf.json
    python -m limbo_tpu_torch.cli bench-bo [--reps 10] [--iters 190]
    python -m limbo_tpu_torch.cli bench-regression [--reps 5]
    python -m limbo_tpu_torch.cli params [--namespace.param=value ...]

Installed, the same commands are ``limbo-tpu-torch <command>``.  A bad
``params`` override exits with code 2.

Reference: wscript:79-86 + waf_tools/limbo.py (create_exp :108, run_local
:290, qsub/oar :311/:339, output_params :359) and waf_tools/benchmarks.py.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="limbo_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("create", help="scaffold a new experiment")
    p.add_argument("--name", required=True)
    p.add_argument("--base-dir", default="exp")
    p.add_argument("--dim_in", type=int, default=2)
    p.add_argument("--dim_out", type=int, default=1)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--samples", type=int, default=10)
    p.add_argument("--iterations", type=int, default=190)
    p.add_argument("--device", default="cuda",
                   help="the device the generated script runs on")

    p = sub.add_parser("run-local", help="run replicates locally")
    p.add_argument("conf")
    p.add_argument("--parallel", type=int, default=1)

    p = sub.add_parser("gen-jobs", help="generate cluster job scripts")
    p.add_argument("conf")

    p = sub.add_parser("bench-bo", help="run the BO benchmark suite")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--iters", type=int, default=190)
    p.add_argument("--out", default="benchmark_results_torch")
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("bench-regression", help="run the regression suite")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default="regression_results_torch")
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("params", help="print the effective config")
    p.add_argument("overrides", nargs="*")

    # `params --ns.param=value`: argparse rejects unknown --options even in
    # REMAINDER position, so collect them via parse_known_args
    args, extras = ap.parse_known_args(argv)
    if args.cmd == "params":
        args.overrides = list(args.overrides) + extras

    if args.cmd == "create":
        from limbo_tpu_torch.experiment.scaffold import create_exp

        path = create_exp(args.name, args.base_dir, args.dim_in, args.dim_out,
                          args.noise, args.samples, args.iterations,
                          device=args.device)
        print(f"created experiment in {path}")
    elif args.cmd == "run-local":
        from limbo_tpu_torch.experiment.launcher import load_conf, run_local

        codes = run_local(load_conf(args.conf), parallel=args.parallel)
        print(f"replicates done, exit codes: {codes}")
        sys.exit(max(codes) if codes else 0)
    elif args.cmd == "gen-jobs":
        from limbo_tpu_torch.experiment.launcher import (generate_job_scripts,
                                                         load_conf)

        for path in generate_job_scripts(load_conf(args.conf)):
            print(path)
    elif args.cmd == "bench-bo":
        from limbo_tpu_torch.benchmarks.bo_suite import run_suite

        run_suite(nb_reps=args.reps, n_iters=args.iters, out_dir=args.out,
                  device=args.device)
    elif args.cmd == "bench-regression":
        from limbo_tpu_torch.benchmarks.regression_suite import (
            run_regression_suite)

        # precise mode (f64 final refit, reference parity) is the default
        run_regression_suite(nb_reps=args.reps, out_dir=args.out,
                             device=args.device)
    elif args.cmd == "params":
        from limbo_tpu_torch.config import Config

        try:
            cfg = Config.from_cli(args.overrides)
        except (AttributeError, KeyError, TypeError, ValueError) as e:
            print(f"error: bad override: {e}", file=sys.stderr)
            sys.exit(2)
        print(cfg.pretty())


if __name__ == "__main__":
    main()
