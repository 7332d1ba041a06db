"""GP regression benchmark harness (port of
limbo_tpu/benchmarks/regression_suite.py).

Reference protocol: waf_tools/benchmarks.py:103-328 +
waf_tools/regression_benchmarks.json: for each function x dim x
n in {50,100,200,400,600} x replicate, sample n noisy training points
uniformly in the native bounds, fit each model spec (GP-SE-Full-Rprop =
SquaredExpARD + noise optimization + KernelLFOpt(Rprop 50, eps_stop 1e-2);
GP-SE-Rprop = the same without noise optimization), then measure the MSE on
fresh test points and the learning and query wall times, beside an f64
NumPy oracle of the same model (benchmarks/oracle.py).

The reference's ``precise`` mode follows JAX's x64 switch; torch has none,
so ``precise`` is an argument here (default True, the protocol of the
reference's recorded run, scripts/run_regression_full.py:18).
"""

from __future__ import annotations

import copy
import json
import math
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from limbo_tpu_torch.benchmarks import oracle as oracle_mod
from limbo_tpu_torch.benchmarks.regression_functions import (
    ALL_REGRESSION,
    RegressionFunction,
)
from limbo_tpu_torch.kernels import SquaredExpARD
from limbo_tpu_torch.means import NullMean
from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.models.hp_opt import KernelLFOpt
from limbo_tpu_torch.opt.gradient import Rprop
from limbo_tpu_torch.utils.device import resolve_device


@dataclass
class ModelSpec:
    name: str
    optimize_noise: bool


DEFAULT_MODELS = [
    ModelSpec("GP-SE-Full-Rprop", optimize_noise=True),
    ModelSpec("GP-SE-Rprop", optimize_noise=False),
]


def _f64(module):
    return copy.deepcopy(module).to(torch.float64)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _make_runner(fn: RegressionFunction, dim: int, n: int, spec: ModelSpec,
                 n_test: int = 2048, noise_std: float = 0.01,
                 dtype=torch.float32, precise: bool = True,
                 hp_restarts: int = 8, hp_epsilon: float = 3.0,
                 device="cuda"):
    """(make_data, fit_fn, query_fn) of one (function, dim, n, model), as
    the reference's (limbo_tpu/benchmarks/regression_suite.py:60-223):

    * make_data(generator) -> (U, Y, Uq, Yq): n training points uniform in
      the unit cube with noisy values of the function at their native
      scale, and n_test noise-free test points;
    * fit_fn(U, Y, generator, pert=None) -> GP: the fit on the unit-cube
      inputs and the two-phase hp-opt.  Phase 1, an f32 multi-start
      (hp_restarts, restart 0 the warm start, one the tiny-noise init
      when the noise is learned) on the ridged objective, its winner
      ranked by the exact f64 LML in precise mode; phase 2 (precise), one
      f64-objective Rprop from the winner, and with the noise learned a
      second f64 ascent from the tiny-noise init, the better by exact f64
      LML; last (precise), the final refit in f64.  pert: phase 1's
      (hp_restarts, P) perturbations, drawn from the generator when None;
    * query_fn(gp, Uq, Yq) -> (mse, mu, var).
    """
    dev = resolve_device(device)
    bounds = fn.bounds_for_dim(dim)
    lo = torch.as_tensor(bounds[:, 0], dtype=dtype, device=dev)
    hi = torch.as_tensor(bounds[:, 1], dtype=dtype, device=dev)
    # bucket capacities (256-multiples) so the n-grid shares shapes
    capacity = max(256, -(-n // 256) * 256)
    # the fixed-noise spec pins the oracle's noise (std 0.01); the
    # noise-optimizing spec keeps limbo's default as its warm start
    kern = SquaredExpARD.create(dim=dim, optimize_noise=spec.optimize_noise,
                                noise=(0.01 if spec.optimize_noise
                                       else 1e-4), dtype=dtype, device=dev)
    hp = KernelLFOpt(optimizer=Rprop(iterations=50, eps_stop=1e-2),
                     objective_jitter="auto",
                     restarts=hp_restarts, epsilon=hp_epsilon,
                     rank_dtype="float64" if precise else None)
    hp_polish = (KernelLFOpt(optimizer=Rprop(iterations=50, eps_stop=1e-2),
                             objective_dtype="float64")
                 if precise else None)
    mean = NullMean()

    def make_data(generator):
        U = torch.rand((n, dim), generator=generator, dtype=dtype,
                       device=dev)
        E = torch.randn((n, 1), generator=generator, dtype=dtype, device=dev)
        Uq = torch.rand((n_test, dim), generator=generator, dtype=dtype,
                        device=dev)
        Y = fn.fn(lo + U * (hi - lo))[:, None].to(dtype) + noise_std * E
        Yq = fn.fn(lo + Uq * (hi - lo))[:, None]
        return U, Y, Uq, Yq

    def fit_fn(U, Y, generator, pert=None):
        gp = gp_mod.fit(kern, mean, U, Y, capacity=capacity, device=dev)
        gp = hp(gp, generator, pert=pert)
        if hp_polish is not None:
            gp = hp_polish(gp, generator)
            if spec.optimize_noise:
                # the second basin: a ridge-free f64 ascent from the
                # tiny-noise init, winner by exact f64 LML
                p = kern.params.clone()
                p[-1] = math.log(0.01)
                gp_tn = hp_polish(gp_mod.fit(kern.with_params(p), mean, U, Y,
                                             capacity=capacity, device=dev),
                                  generator)
                U64, Y64 = U.to(torch.float64), Y.to(torch.float64)

                def lml64(g):
                    return gp_mod.log_marginal_likelihood(
                        _f64(g.kernel), mean, U64, Y64, g.n)

                with torch.no_grad():
                    better_tn = lml64(gp_tn) > lml64(gp)
                p = torch.where(better_tn, gp_tn.kernel.params,
                                gp.kernel.params)
                gp = gp.replace(kernel=gp.kernel.with_params(p))
        if precise:
            # the final factorization at the learned hyperparameters in f64
            gp = gp_mod.fit(_f64(gp.kernel), mean, U.to(torch.float64),
                            Y.to(torch.float64), capacity=capacity,
                            device=dev)
        return gp

    def query_fn(gp, Uq, Yq):
        with torch.no_grad():
            mu, var = gp_mod.query(gp, Uq.to(gp.x.dtype))
        mse = torch.mean((mu - Yq.to(mu.dtype)) ** 2)
        return mse, mu, var

    return make_data, fit_fn, query_fn


def run_regression_suite(functions: Optional[List[RegressionFunction]] = None,
                         models: Optional[List[ModelSpec]] = None,
                         points=(50, 100, 200, 400, 600), nb_reps: int = 10,
                         out_dir: str = "regression_results_torch",
                         dtype=torch.float32, with_oracle: bool = True,
                         oracle_reps: int = 3, verbose: bool = True,
                         precise: bool = True, device="cuda") -> Dict:
    """The full protocol (waf_tools/regression_benchmarks.json: functions x
    dims x n x replicates) with the f64 NumPy oracle on the first
    oracle_reps replicates; writes <tag>.dat rows 'mse learn_ms query_ms'
    and <tag>.oracle.dat rows 'mse learn_s query_s'.

    Resume: recorded replicates are kept and only the missing rep indices
    run (rep r draws from a generator seeded with 97 r + 13).  Unlike the
    reference, summary.json is merged with what it held, so one function
    at a time can be run into one directory."""
    functions = functions if functions is not None else ALL_REGRESSION
    models = models if models is not None else DEFAULT_MODELS
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    summary = {}
    for fn in functions:
        for dim in fn.dims:
            for n in points:
                for spec in models:
                    tag = f"{fn.name}_d{dim}_n{n}_{spec.name}"
                    summary[tag] = _run_tag(
                        fn, dim, n, spec, tag, nb_reps, out_dir, dtype,
                        with_oracle, oracle_reps, verbose, precise, dev)
    path = os.path.join(out_dir, "summary.json")
    merged = {}
    if os.path.exists(path):
        with open(path) as fh:
            merged = json.load(fh)
    merged.update(summary)
    with open(path, "w") as fh:
        json.dump(merged, fh, indent=1)
    return merged


def _run_tag(fn, dim, n, spec, tag, nb_reps, out_dir, dtype, with_oracle,
             oracle_reps, verbose, precise, dev) -> Dict:
    """One (function, dim, n, model): the missing replicates and oracle
    replicates, appended to the tag's files; returns its summary row."""
    dat_path = os.path.join(out_dir, tag + ".dat")
    ora_path = os.path.join(out_dir, tag + ".oracle.dat")
    mses, t_learn, t_query = [], [], []
    o_mses, o_learn, o_query = [], [], []
    done = 0
    if os.path.exists(dat_path):
        rows = np.loadtxt(dat_path, ndmin=2)
        done = min(rows.shape[0], nb_reps)
        mses = [float(v) for v in rows[:done, 0]]
        t_learn = [v / 1e3 for v in rows[:done, 1]]
        t_query = [v / 1e3 for v in rows[:done, 2]]
    o_done = 0
    if os.path.exists(ora_path):
        orows = np.loadtxt(ora_path, ndmin=2)
        o_done = min(orows.shape[0], oracle_reps)
        o_mses = [float(v) for v in orows[:o_done, 0]]
        o_learn = [v for v in orows[:o_done, 1]]
        o_query = [v for v in orows[:o_done, 2]]
    if done < nb_reps or (with_oracle and o_done < oracle_reps):
        make_data, fit_fn, query_fn = _make_runner(
            fn, dim, n, spec, dtype=dtype, precise=precise, device=dev)
    warmed = False
    for rep in range(nb_reps):
        need_run = rep >= done
        need_oracle = with_oracle and o_done <= rep < oracle_reps
        if not (need_run or need_oracle):
            continue
        gen = torch.Generator(device=dev).manual_seed(rep * 97 + 13)
        U, Y, Uq, Yq = make_data(gen)
        if need_run:
            if not warmed:          # the first run of a tag is not timed
                query_fn(fit_fn(U, Y, torch.Generator(
                    device=dev).manual_seed(rep * 97 + 13)), Uq, Yq)
                warmed = True
            _sync(dev)
            t0 = time.perf_counter()
            gp = fit_fn(U, Y, gen)
            _sync(dev)
            tl = time.perf_counter() - t0
            t0 = time.perf_counter()
            mse, mu, var = query_fn(gp, Uq, Yq)
            mse = float(mse)                      # waits on the card
            tq = time.perf_counter() - t0
            t_learn.append(tl)
            t_query.append(tq)
            mses.append(mse)
            with open(dat_path, "a") as fh:
                fh.write(f"{mse:.8f} {tl*1e3:.3f} {tq*1e3:.3f}\n")
        if need_oracle:
            om, ol, oq = oracle_mod.fit_and_eval(
                U.cpu().numpy(), Y.cpu().numpy(), Uq.cpu().numpy(),
                Yq.cpu().numpy(), optimize_noise=spec.optimize_noise)
            o_mses.append(om)
            o_learn.append(ol)
            o_query.append(oq)
            with open(ora_path, "a") as fh:
                fh.write(f"{om:.8f} {ol:.6f} {oq:.6f}\n")
    row = {"mse": float(np.median(mses)),
           "learn_ms": float(np.median(t_learn)) * 1e3,
           "query_ms": float(np.median(t_query)) * 1e3}
    if o_mses:
        row["oracle_mse"] = float(np.median(o_mses))
        row["oracle_learn_ms"] = float(np.median(o_learn)) * 1e3
        row["oracle_query_ms"] = float(np.median(o_query)) * 1e3
        row["vs_oracle_learn"] = (row["oracle_learn_ms"]
                                  / max(row["learn_ms"], 1e-9))
        row["vs_oracle_query"] = (row["oracle_query_ms"]
                                  / max(row["query_ms"], 1e-9))
    if verbose:
        extra = (f" | oracle mse={row.get('oracle_mse', 0):.5f}"
                 f" {row.get('vs_oracle_learn', 0):.1f}x learn"
                 if o_mses else "")
        print(f"{tag:50s} mse={row['mse']:.5f} "
              f"learn={row['learn_ms']:.1f}ms "
              f"query={row['query_ms']:.2f}ms{extra}", flush=True)
    return row
