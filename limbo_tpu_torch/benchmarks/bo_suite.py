"""The BO benchmark harness (port of limbo_tpu/benchmarks/bo_suite.py).

Reference protocol: src/benchmarks/limbo/bench.cpp:140-262 + waf_tools/
benchmarks.py:71: for each variant {LIMBO_DEF, LIMBO_DEF_HPOPT, OPT_CMAES,
OPT_DIRECT, ACQ_UCB, ACQ_EI} (and the recorded acq_wide) x each of the 8
test functions x nb_reps: 10 random init points + 190 BO iterations, then
"accuracy time_ms" appended to <variant>/<function>.dat.

Variants are configurations; every (variant, function) run goes through
``BOptimizer.optimize_jit``, so on the card each iteration is a replay of
one captured CUDA graph (bo/graph.py), captured anew in every run.
``time_ms`` is the run's host time up to a ``torch.cuda.synchronize()``
(init design, warm-up and capture included); ``compile_ms`` holds the
first replicate's warm-up and capture.  Replicate rep draws from a
``torch.Generator`` seeded with 1000 * rep + 7.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from limbo_tpu_torch.acqui.acqui import EI, UCB
from limbo_tpu_torch.benchmarks.functions import ALL_FUNCTIONS, TestFunction
from limbo_tpu_torch.bo.init_designs import RandomSampling
from limbo_tpu_torch.bo.optimizer import BOptimizer
from limbo_tpu_torch.bo.stop import MaxIterations
from limbo_tpu_torch.kernels import MaternFiveHalves, SquaredExpARD
from limbo_tpu_torch.models.hp_opt import KernelLFOpt
from limbo_tpu_torch.opt.cmaes import Cmaes
from limbo_tpu_torch.opt.compose import RandomRestarts
from limbo_tpu_torch.opt.direct import DirectL
from limbo_tpu_torch.opt.gradient import Rprop
from limbo_tpu_torch.utils.device import resolve_device


@dataclass
class Variant:
    """≙ one compiled benchmark binary (src/benchmarks/wscript:84-95)."""

    name: str
    acqui: object
    acqui_optimizer: object
    hp_opt: bool = False
    hp_period: int = 50


def default_variants() -> List[Variant]:
    """The reference's 7 variants with its exact settings
    (limbo_tpu/benchmarks/bo_suite.py:52-81): bench.cpp's UCB alpha =
    0.125; the 64 x Rprop(20) ascent from a 1024-point sweep; CMA-ES 80
    generations of 16; DIRECT-L 64 rounds of 16 splits (2049 centers, the
    order of the ascent's 2064 queries); acq_wide, the recorded
    wide-over-deep schedule (64 x Rprop(15))."""
    grad_restarts = RandomRestarts(sub=Rprop(iterations=20), repeats=64,
                                   sweep_samples=1024)
    cmaes = Cmaes(iterations=80, pop_size=16)
    wide_restarts = RandomRestarts(sub=Rprop(iterations=15), repeats=64,
                                   sweep_samples=1024)
    direct = DirectL(rounds=64, splits_per_round=16)
    return [
        Variant("limbo_def", UCB(alpha=0.125), grad_restarts),
        Variant("limbo_def_hpopt", UCB(alpha=0.125), grad_restarts,
                hp_opt=True),
        Variant("opt_cmaes", UCB(alpha=0.125), cmaes),
        Variant("opt_direct", UCB(alpha=0.125), direct),
        Variant("acq_ei", EI(), grad_restarts),
        Variant("acq_ucb", UCB(alpha=0.125), grad_restarts),
        Variant("acq_wide", UCB(alpha=0.125), wide_restarts),
    ]


def hp_strategy() -> KernelLFOpt:
    """The hp-opt variant's learning: bench.cpp's opt_rprop (300
    iterations) with eps_stop = 1e-6, as the reference's, with its
    dtype-scaled ridge on the objective and 5 perturbed restarts."""
    return KernelLFOpt(optimizer=Rprop(iterations=300, eps_stop=1e-6),
                       restarts=5, epsilon=0.5, objective_jitter="auto")


def make_optimizer(variant: Variant, fn: TestFunction, n_init: int = 10,
                   n_iters: int = 190, dtype=torch.float32,
                   device="cuda") -> BOptimizer:
    """The BOptimizer of one (variant, function) run, as the reference's
    run_one builds it."""
    kwargs = dict(acqui=variant.acqui,
                  acqui_optimizer=variant.acqui_optimizer,
                  init=RandomSampling(n_init),
                  stop=(MaxIterations(n_iters),), stats_enabled=False,
                  dtype=dtype, device=device)
    if variant.hp_opt:
        kwargs["kernel"] = SquaredExpARD.create(dim=fn.dim_in, noise=1e-10,
                                                dtype=dtype, device=device)
        kwargs["hp_opt"] = hp_strategy()
        kwargs["hp_period"] = variant.hp_period
    else:
        # bench.cpp Params: near-zero noise (an interpolating GP); the
        # benchmark functions are deterministic
        kwargs["kernel"] = MaternFiveHalves.create(noise=1e-10, dtype=dtype,
                                                   device=device)
    return BOptimizer(**kwargs)


def run_one(variant: Variant, fn: TestFunction, n_init: int = 10,
            n_iters: int = 190, seed: int = 7, dtype=torch.float32,
            measure_compile: bool = True, device="cuda"):
    """One replicate; returns (accuracy, wall_ms, compile_ms).

    wall_ms: optimize_jit's host time up to a synchronize; compile_ms: its
    first iteration's warm-up and capture when measure_compile (0.0 on the
    CPU, where nothing is captured), else 0.0."""
    dev = resolve_device(device)
    bo = make_optimizer(variant, fn, n_init, n_iters, dtype, dev)
    f = fn.as_max_objective(dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, history = bo.optimize_jit(f, dim_in=fn.dim_in, generator=gen,
                                 n_iterations=n_iters)
    best = float(history["best"][-1])           # maximized -f; waits
    wall_ms = (time.perf_counter() - t0) * 1e3
    compile_ms = history["capture_s"] * 1e3 if measure_compile else 0.0
    return fn.accuracy(-best), wall_ms, compile_ms


def run_suite(variants: Optional[List[Variant]] = None,
              functions: Optional[List[TestFunction]] = None,
              nb_reps: int = 10, n_init: int = 10, n_iters: int = 190,
              out_dir: str = "benchmark_results_torch",
              dtype=torch.float32, verbose: bool = True,
              device="cuda") -> Dict:
    """Full suite (waf run_bo_benchmarks parity); writes <v>/<f>.dat rows
    'accuracy time_ms' and merges a summary.json.

    Resume: recorded replicates are kept and only the missing rep indices
    run (each rep's seed is fixed), so a partial file continues where it
    stopped, with no duplicate rows."""
    variants = variants if variants is not None else default_variants()
    functions = functions if functions is not None else ALL_FUNCTIONS
    os.makedirs(out_dir, exist_ok=True)
    summary = {}
    for v in variants:
        vdir = os.path.join(out_dir, v.name)
        os.makedirs(vdir, exist_ok=True)
        for fn in functions:
            dat = os.path.join(vdir, fn.name + ".dat")
            done = 0
            accs, times, compiles = [], [], []
            if os.path.exists(dat):
                rows = np.loadtxt(dat, ndmin=2)
                done = min(rows.shape[0], nb_reps)
                accs = [float(a) for a in rows[:done, 0]]
                times = [float(t) for t in rows[:done, 1]]
                if done >= nb_reps:
                    summary[f"{v.name}/{fn.name}"] = {
                        "accuracy": float(np.median(rows[:nb_reps, 0])),
                        "time_ms": float(np.median(rows[:nb_reps, 1])),
                        "compile_ms": 0.0}
                    if verbose:
                        print(f"{v.name:18s} {fn.name:16s} resumed "
                              f"({done} replicates on disk)", flush=True)
                    continue
                if done and verbose:
                    print(f"{v.name:18s} {fn.name:16s} resuming at "
                          f"replicate {done}/{nb_reps}", flush=True)
            for rep in range(done, nb_reps):
                acc, ms, comp_ms = run_one(v, fn, n_init, n_iters,
                                           1000 * rep + 7, dtype,
                                           measure_compile=(rep == 0),
                                           device=device)
                accs.append(acc)
                times.append(ms)
                compiles.append(comp_ms)
                with open(dat, "a") as fh:
                    fh.write(f"{acc:.6f} {ms:.3f}\n")
            med_acc = float(np.median(accs))
            med_ms = float(np.median(times))
            summary[f"{v.name}/{fn.name}"] = {
                "accuracy": med_acc, "time_ms": med_ms,
                "compile_ms": float(compiles[0])}
            if verbose:
                print(f"{v.name:18s} {fn.name:16s} "
                      f"acc={med_acc:.4f} time={med_ms:.1f}ms "
                      f"compile={compiles[0]:.0f}ms", flush=True)
    # merge into any existing summary: a partial run (a subset of variants
    # or functions) must not clobber previously recorded entries
    path = os.path.join(out_dir, "summary.json")
    merged = {}
    if os.path.exists(path):
        with open(path) as fh:
            merged = json.load(fh)
    merged.update(summary)
    with open(path, "w") as fh:
        json.dump(merged, fh, indent=1)
    return merged
