"""Large-n Bayesian optimization on the cached-K^-1 path (the port of
examples/large_n.py).

A big pre-existing dataset (N = 10,000 observations, the card-scale size
the JAX example names) seeds the model, and 20 BO iterations run on the
K^-1 query cache: matmul-only posterior queries, O(N) "deferred" appends,
a bf16 query mirror and no f32 K^-1 master (lite).  On the card the
mirror product runs on the port's exact-sum kernel and the cache build on
the tri-inv panel kernel.

    python3 examples/torch/large_n.py          # on the card
    python3 -c "import runpy; runpy.run_path('examples/torch/large_n.py',
        run_name='x')['main'](device='cpu', n=500)"   # on the CPU
"""

import time

import numpy as np
import torch

from limbo_tpu_torch.bo import BOptimizer, BOState, MaxIterations, NoInit
from limbo_tpu_torch.kernels import SquaredExpARD
from limbo_tpu_torch.models import gp as gp_mod

N = 10_000         # pre-existing observations
D = 6
ITERS = 20


def objective(x):
    x = np.asarray(x)
    return np.array([float(np.sin(3.0 * x.sum())
                           - 0.5 * ((x - 0.4) ** 2).sum())])


def main(device="cuda", n=N, iterations=ITERS, seed=0):
    # a big pre-existing dataset (e.g. logs of a prior campaign)
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, D)).astype(np.float32)
    Y = np.array([objective(x) for x in X], dtype=np.float32)

    bo = BOptimizer(
        kernel=SquaredExpARD.create(dim=D, device=device),
        init=NoInit(),                       # data comes from `state` below
        stop=(MaxIterations(iterations),),
        use_query_cache=True,                # matmul-only posterior queries
        cache_fast_update="deferred",        # O(N) appends, rank-m query corr
        cache_query_dtype=torch.bfloat16,    # halve the read per query
        cache_lite=True,                     # mirror-only: no f32 K^-1 master
        cache_defer_m=128,                   # flush cadence (lite: size it big)
        stats_enabled=False,
        device=device,
    )

    # seed the model with the existing data, then let optimize() resume
    capacity = bo._capacity(extra=n)
    gp = gp_mod.fit(bo.kernel, bo._make_gp(D, 1, capacity).mean, X, Y,
                    capacity=capacity, device=device)
    gen = torch.Generator(device=bo.device).manual_seed(seed + 1)
    state = BOState(gp=gp, generator=gen)

    t0 = time.perf_counter()
    state = bo.optimize(objective, D, reset=False, state=state,
                        generator=gen)
    dt = time.perf_counter() - t0
    print(f"{iterations} BO iterations over {state.gp.n} observations "
          f"in {dt:.1f}s ({iterations / dt:.1f} iters/s)")
    print(f"best value {state.best_value:.4f} at {state.best_sample}")
    return state


if __name__ == "__main__":
    main()
