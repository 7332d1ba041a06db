#!/usr/bin/env python3
"""BO iterations/s of the PyTorch / H100 port at n = 10k observations: the
port's counterpart of bench.py.

Run from the repository root on a machine with one NVIDIA H100:

    python3 bench_torch.py [--iters 10]

Prints ONE JSON line on stdout (progress on stderr):
  {"metric": "torch_bo_iterations_per_s_n10k", "value": <captured>,
   "unit": ..., "uncaptured": <eager>, "vs_baseline": <captured / numpy>}

The workload is bench.py's, through the port's public entry points: n =
10,000 points in d = 8 with y = sin(3 sum x) + 0.1 e, SquaredExpARD (l = 1,
noise 0.01) + DataMean fitted at capacity ceil((n + 8 iters + 2) / 512) 512
(bench.py:73 with twice its groups; 10240 at n = 10k), the K^-1 query cache
with Linv, a bf16 mirror and defer_m = 32, and per iteration
RandomRestarts(Rprop(20), 64 restarts, a 1024-point sweep) maximizing UCB
(alpha 0.5), the objective sin(3 sum x) on the device, and one deferred
append.  The iteration is ``bo/graph.BOStep``: captured as CUDA graphs and
replayed (``value``), or the same step run eagerly (``uncaptured``).

After the fit, the cache build and one warm-up iteration (which is also the
capture), 4 groups of ``--iters`` captured iterations and as many
uncaptured ones alternate in one process (their order turning each group),
each group timed on the host clock up to a synchronize; each mode's rate is
its best group, as bench.py's.  A non-finite factor or alpha at the end
fails the run (bench.py:142-144): a NaN factor times like a real one.

vs_baseline: the captured rate over bench.py's NumPy f64 loop on the host
(its own copy here, ``bench_numpy``): a real fit and inverse, then every
posterior evaluation of the schedule against the real K^-1, best of two
iterations (not charged for gradients, so the ratio is a lower bound).

Precision is the process's: exact f32 (TF32 off) unless
LIMBO_TPU_FAST_MATMUL is set, which bench.py sets by default and this
script does not (limbo_tpu_torch/utils/precision.py: TF32 where the JAX
package leaves its default precision); the unit string says which ran.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

N_POINTS, DIM = 10_000, 8
RESTARTS, ASCENT_STEPS, SWEEP, DEFER_M = 64, 20, 1024, 32
QUERIES_PER_ITER = RESTARTS * ASCENT_STEPS + SWEEP + RESTARTS
GROUPS = 4
METRIC = "torch_bo_iterations_per_s_n10k"


def _log(msg: str) -> None:
    print(f"[bench_torch] {msg}", file=sys.stderr, flush=True)


def make_step(n: int, d: int, iters: int, device, seed: int = 0):
    """The fitted workload as a BOStep (captured on a card), with its
    set-up seconds: (step, fit seconds, build seconds)."""
    from limbo_tpu_torch.acqui import UCB
    from limbo_tpu_torch.bo.graph import BOStep
    from limbo_tpu_torch.kernels import SquaredExpARD
    from limbo_tpu_torch.means import DataMean
    from limbo_tpu_torch.models import gp as gp_mod
    from limbo_tpu_torch.opt import RandomRestarts, Rprop

    dev = torch.device(device)
    capacity = -(-(n + 2 * GROUPS * iters + 2) // 512) * 512
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.rand((n, d), generator=gen, device=dev)
    Y = (torch.sin(3.0 * X.sum(dim=1, keepdim=True))
         + 0.1 * torch.randn((n, 1), generator=gen, device=dev))
    kernel = SquaredExpARD.create(dim=d, device=dev)
    mean = DataMean.create(dim_out=1, device=dev)
    t0 = time.perf_counter()
    gp = gp_mod.fit(kernel, mean, X, Y, capacity=capacity, device=dev)
    _sync(dev)
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache = gp_mod.QueryCache.build(gp, with_Linv=True,
                                    qdtype=torch.bfloat16, defer_m=DEFER_M)
    _sync(dev)
    t_build = time.perf_counter() - t0
    opt = RandomRestarts(sub=Rprop(iterations=ASCENT_STEPS),
                         repeats=RESTARTS, sweep_samples=SWEEP)
    acq = UCB(alpha=0.5)
    start = torch.full((d,), 0.5, device=dev)

    def propose(model, it):
        return opt(lambda Z: acq(model, Z), start, gen, True).x

    def objective(x):
        return torch.sin(3.0 * torch.sum(x))[None]

    step = BOStep(gp, cache, propose, objective, gen,
                  fast_update="deferred")
    return step, t_fit, t_build


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def check_finite(gp) -> None:
    """bench.py's numerics guard: a NaN factor times exactly like a real
    one, so a non-finite L or alpha fails the run."""
    if not (bool(torch.isfinite(gp.L).all())
            and bool(torch.isfinite(gp.alpha).all())):
        raise AssertionError("bench state went non-finite - timings would "
                             "be invalid")


def bench(n: int = N_POINTS, d: int = DIM, iters: int = 10,
          device="cuda") -> dict:
    """Captured and uncaptured BO iterations/s of the workload, alternated
    in one process (best group each); on the CPU both run eagerly."""
    step, t_fit, t_build = make_step(n, d, iters, device)
    _log(f"fit {t_fit:.3f} s, cache build {t_build:.3f} s (n {n}, "
         f"capacity {step.gp.capacity})")
    dev = step.gp.x.device
    t0 = time.perf_counter()
    step.step()                          # warm-up (and capture on a card)
    _sync(dev)
    _log(f"warm-up iteration (and capture) {time.perf_counter() - t0:.3f} s")
    best = {"captured": math.inf, "uncaptured": math.inf}
    for g in range(GROUPS):
        order = ("captured", "uncaptured")
        for mode in order if g % 2 == 0 else order[::-1]:
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                step.step(eager=mode == "uncaptured")
            _sync(dev)
            dt = (time.perf_counter() - t0) / iters
            _log(f"group {g} {mode}: {1.0 / dt:.3f} iters/s")
            best[mode] = min(best[mode], dt)
    check_finite(step.gp)
    return dict(captured=1.0 / best["captured"],
                uncaptured=1.0 / best["uncaptured"], fit_s=t_fit,
                build_s=t_build, n_final=step.gp.n,
                launches_per_replay=step.launches())


def bench_numpy(n: int = N_POINTS, d: int = DIM, iters: int = 2) -> float:
    """bench.py's NumPy f64 loop (bench.py:148-204), copied: a real GP fit
    (Cholesky, L^-1, K^-1), then per iteration every posterior evaluation
    of the schedule against the real K^-1 and the rank-1 update; returns
    the best iteration's rate."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(n, d))
    Y = np.sin(3.0 * X.sum(axis=1, keepdims=True)) \
        + 0.1 * rng.standard_normal((n, 1))

    def sqdist(Aq, B):
        return ((Aq * Aq).sum(1)[:, None] + (B * B).sum(1)[None, :]
                - 2 * Aq @ B.T)

    t0 = time.perf_counter()
    K = np.exp(-0.5 * sqdist(X, X)) + 1e-2 * np.eye(n)
    L = np.linalg.cholesky(K)
    Linv = np.linalg.solve(L, np.eye(n))
    Kinv = Linv.T @ Linv
    alpha = Kinv @ Y
    del K, L, Linv
    _log(f"numpy f64 fit: {time.perf_counter() - t0:.1f} s")

    def query(Xq):
        ks = np.exp(-0.5 * sqdist(Xq, X))
        mu = ks @ alpha
        t = ks @ Kinv
        return mu, 1.0 - (t * ks).sum(1)

    t_iter = math.inf
    for _ in range(iters):
        t0 = time.perf_counter()
        xs = rng.uniform(size=(RESTARTS, d))
        for _ in range(ASCENT_STEPS):
            query(xs)
            xs = np.clip(xs + 1e-3 * rng.standard_normal(xs.shape), 0, 1)
        query(rng.uniform(size=(SWEEP, d)))
        query(xs)
        k = np.exp(-0.5 * sqdist(rng.uniform(size=(1, d)), X))[0]
        u = Kinv @ k
        s_piv = max(1.0 + 1e-2 - k @ u, 1e-10)
        Kinv += np.outer(u, u) / s_piv
        alpha = Kinv @ Y
        t_iter = min(t_iter, time.perf_counter() - t0)
    _log(f"numpy iteration: {t_iter:.3f} s")
    return 1.0 / t_iter


def result_line(res: dict, numpy_rate: float, card: str, n: int) -> dict:
    """The one JSON line: the captured rate as the value."""
    from limbo_tpu_torch.utils import precision

    tf32 = ("TF32 at the fast-mode sites" if precision.fast_mode()
            else "TF32 off")
    return {
        "metric": METRIC,
        "value": res["captured"],
        "unit": (f"BO iters/s at n={n} obs, d={DIM}, {QUERIES_PER_ITER} "
                 f"posterior evals/iter, f32 ({tf32}), bf16 K^-1 mirror, "
                 f"CUDA-graph replay of the iteration; on {card}; "
                 "uncaptured = the same step run eagerly, alternated in one "
                 "process; vs_baseline = captured over a measured "
                 "same-algorithm NumPy f64 loop (a lower bound: the "
                 "baseline is not charged for gradients)"),
        "uncaptured": res["uncaptured"],
        "vs_baseline": res["captured"] / numpy_rate,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (reads LIMBO_TPU_FAST_MATMUL)
    from chip_smoke import card_line
    from limbo_tpu_torch.ops import _cuda

    card = card_line()
    _log(f"card: {card}; torch {torch.__version__}")
    _log(f"kernel build {_cuda.build_all():.1f} s")
    res = bench(iters=args.iters)
    _log(f"captured {res['captured']:.3f}, uncaptured "
         f"{res['uncaptured']:.3f} iters/s; launches per replay "
         f"{res['launches_per_replay']}")
    rate_np = bench_numpy()
    _log(f"numpy baseline {rate_np:.4f} iters/s")
    print(json.dumps(result_line(res, rate_np, card, N_POINTS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
