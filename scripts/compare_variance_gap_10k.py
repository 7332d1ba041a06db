#!/usr/bin/env python3
"""How far the cached posterior variance is from the exact one at bench.py's
size, in the JAX package and in the PyTorch port, on the same data.

    JAX_PLATFORMS=cpu python3 scripts/compare_variance_gap_10k.py [--queries 64]

bench.py's workload: n = 10,000, d = 8, its data (jax.random.PRNGKey(0):
X uniform, y = sin(3 sum x) + 0.1 e), SquaredExpARD (l = 1, sigma^2 = 1,
noise 0.01) + DataMean, capacity 10240.  Both packages fit in f32 on the CPU
(stock Cholesky and triangular solves) and build QueryCache(with_Linv=True,
qdtype=bf16); query_cached then answers at seeded points, through the bf16
mirror and through the f32 master K^-1 (the cache without its mirror).
Each answer is compared with the f64 posterior of the same data, computed
with numpy/scipy and none of either package's code.  Needs ~8 GB of host
memory and a few minutes; it is not part of the test suite.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.linalg as sl  # noqa: E402
import torch  # noqa: E402

import limbo_tpu.kernels as jk  # noqa: E402
import limbo_tpu.means as jm  # noqa: E402
from limbo_tpu.models import gp as jgp  # noqa: E402
from limbo_tpu_torch import kernels, means  # noqa: E402
from limbo_tpu_torch.models import gp as tgp  # noqa: E402

N_POINTS, DIM, CAPACITY = 10_000, 8, 10_240
# the f32 model's training diagonal: noise + 32 f32 eps (sigma^2 = 1)
DIAG_ADD = 0.01 + 32 * 2.0 ** -23


def sq_dist64(A, B):
    return np.maximum((A * A).sum(1)[:, None] + (B * B).sum(1)[None, :]
                      - 2.0 * A @ B.T, 0.0)


def posterior_f64(X, Y, Xq):
    K = np.exp(-0.5 * sq_dist64(X, X))
    K[np.diag_indices_from(K)] += DIAG_ADD
    L = np.linalg.cholesky(K)
    del K
    ybar = Y.mean(axis=0)
    alpha = sl.cho_solve((L, True), Y - ybar)
    ks = np.exp(-0.5 * sq_dist64(Xq, X))
    z = sl.solve_triangular(L, ks.T, lower=True)
    return (ks @ alpha + ybar)[:, 0], np.maximum(1.0 - (z * z).sum(0), 0.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    kx, ky = jax.random.split(jax.random.PRNGKey(0))
    X = jax.random.uniform(kx, (N_POINTS, DIM), dtype=jnp.float32)
    Y = jnp.sin(3.0 * jnp.sum(X, axis=1, keepdims=True)) \
        + 0.1 * jax.random.normal(ky, (N_POINTS, 1), dtype=jnp.float32)
    Xn, Yn = np.asarray(X), np.asarray(Y)
    Xq = np.random.default_rng(args.seed).uniform(
        size=(args.queries, DIM)).astype(np.float32)
    t0 = time.perf_counter()
    mu64, var64 = posterior_f64(Xn.astype(np.float64), Yn.astype(np.float64),
                                Xq.astype(np.float64))
    print(f"f64 posterior: {time.perf_counter() - t0:.1f} s", flush=True)

    def report(pkg, mu, var, name):
        mu = np.asarray(mu, np.float64)[:, 0]
        var = np.asarray(var, np.float64)
        print(f"{pkg} through the {name}: max |mu - mu64| "
              f"{np.abs(mu - mu64).max():.3e}, max |var - var64| "
              f"{np.abs(var - var64).max():.3e}, mean |var - var64| "
              f"{np.abs(var - var64).mean():.3e}", flush=True)

    t0 = time.perf_counter()
    gj = jax.jit(lambda X, Y: jgp.fit(
        jk.SquaredExpARD.create(dim=DIM, dtype=jnp.float32),
        jm.DataMean.create(dtype=jnp.float32), X, Y, capacity=CAPACITY))(X, Y)
    cj = jax.jit(lambda g: jgp.QueryCache.build(
        g, with_Linv=True, qdtype=jnp.bfloat16))(gj)
    qj = jax.jit(jgp.query_cached)
    for name, c in (("bf16 mirror", cj), ("f32 master", cj.replace(
            Kinv_q=None))):
        report("JAX package", *qj(gj, c, jnp.asarray(Xq)), name)
    print(f"JAX package: {time.perf_counter() - t0:.1f} s", flush=True)
    del gj, cj

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    gt = tgp.fit(kernels.SquaredExpARD.create(dim=DIM, device="cpu"),
                 means.DataMean.create(device="cpu"), Xn, Yn,
                 capacity=CAPACITY, device="cpu")
    ct = tgp.QueryCache.build(gt, with_Linv=True, qdtype=torch.bfloat16)
    with torch.no_grad():
        for name, c in (("bf16 mirror", ct), ("f32 master",
                                              ct.replace(Kinv_q=None))):
            mu, var = tgp.query_cached(gt, c, torch.from_numpy(Xq))
            report("port", mu.numpy(), var.numpy(), name)
        ks = gt.kernel.gram(torch.from_numpy(Xq), gt.x) * gt.mask[None, :]
        absq = ((ks.abs() @ ct.Kinv.abs()) * ks.abs()).sum(1).max()
    print(f"port: {time.perf_counter() - t0:.1f} s; max sum|ks_i Kinv_ij "
          f"ks_j| {float(absq):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
