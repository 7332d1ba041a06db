#!/usr/bin/env python3
"""How far the cached appends' posterior mean drifts from the exact one at
bench.py's size, per append mode, in the JAX package and in the PyTorch
port, on the same data.

    JAX_PLATFORMS=cpu python3 scripts/compare_append_modes_10k.py [--appends 3]

bench.py's workload: n = 10,000, d = 8, its data (jax.random.PRNGKey(0):
X uniform, y = sin(3 sum x) + 0.1 e), SquaredExpARD (l = 1, sigma^2 = 1,
noise 0.01) + DataMean, capacity 10240.  Both packages fit in f32 on the
CPU, then each append mode ("refined" with K kept, True, "linv" with Linv
kept, and the two-solve default) appends the same seeded points.  The
posterior mean (through L and alpha) at seeded queries is compared with
the f64 posterior of the same data, computed with numpy/scipy and none of
either package's code, right after the fit and after the appends.  Needs
~8 GB of host memory and a few minutes; it is not part of the test suite.
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
MODES = (("refined", dict(with_K=True)), (True, {}),
         ("linv", dict(with_Linv=True)), (False, {}))


def sq_dist64(A, B):
    return np.maximum((A * A).sum(1)[:, None] + (B * B).sum(1)[None, :]
                      - 2.0 * A @ B.T, 0.0)


def mean_f64(X, Y, Xq):
    K = np.exp(-0.5 * sq_dist64(X, X))
    K[np.diag_indices_from(K)] += DIAG_ADD
    L = np.linalg.cholesky(K)
    del K
    ybar = Y.mean(axis=0)
    alpha = sl.cho_solve((L, True), Y - ybar)
    return (np.exp(-0.5 * sq_dist64(Xq, X)) @ alpha + ybar)[:, 0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--appends", type=int, default=3)
    ap.add_argument("--queries", type=int, default=16)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(os.cpu_count() or 1)
    kx, ky = jax.random.split(jax.random.PRNGKey(0))
    X = jax.random.uniform(kx, (N_POINTS, DIM), dtype=jnp.float32)
    Y = jnp.sin(3.0 * jnp.sum(X, axis=1, keepdims=True)) \
        + 0.1 * jax.random.normal(ky, (N_POINTS, 1), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    Xq = rng.uniform(size=(args.queries, DIM)).astype(np.float32)
    Xa = rng.uniform(size=(args.appends, DIM)).astype(np.float32)
    Ya = np.sin(3.0 * Xa.sum(1, keepdims=True)).astype(np.float32)
    X64 = np.asarray(X, np.float64)
    Y64 = np.asarray(Y, np.float64)
    t0 = time.perf_counter()
    fit64 = mean_f64(X64, Y64, Xq.astype(np.float64))
    app64 = mean_f64(np.vstack([X64, Xa]), np.vstack([Y64, Ya]),
                     Xq.astype(np.float64))
    print(f"f64 posteriors: {time.perf_counter() - t0:.1f} s", flush=True)

    def err(mu, want):
        return float(np.abs(np.asarray(mu, np.float64)[:, 0] - want).max())

    gj = jax.jit(lambda X, Y: jgp.fit(
        jk.SquaredExpARD.create(dim=DIM, dtype=jnp.float32),
        jm.DataMean.create(dtype=jnp.float32), X, Y, capacity=CAPACITY))(X, Y)
    qj = jax.jit(jgp.query)
    print(f"JAX package, after the fit: max |mu - mu64| "
          f"{err(qj(gj, jnp.asarray(Xq))[0], fit64):.3e}", flush=True)
    gt = tgp.fit(kernels.SquaredExpARD.create(dim=DIM, device="cpu"),
                 means.DataMean.create(device="cpu"), np.array(X),
                 np.array(Y), capacity=CAPACITY, device="cpu")
    with torch.no_grad():
        mt = tgp.query(gt, torch.from_numpy(Xq))[0].numpy()
    print(f"port, after the fit: max |mu - mu64| {err(mt, fit64):.3e}",
          flush=True)
    for mode, kw in MODES:
        cj = jax.jit(lambda g, kw=kw: jgp.QueryCache.build(g, **kw))(gj)
        add = jax.jit(lambda g, c, x, y, mode=mode: jgp.add_sample_cached(
            g, c, x, y, fast_update=mode))
        g = gj
        for x, y in zip(Xa, Ya):
            g, cj = add(g, cj, jnp.asarray(x), jnp.asarray(y))
        ej = err(qj(g, jnp.asarray(Xq))[0], app64)
        g2 = gt.replace(**{k: getattr(gt, k).clone()
                           for k in ("x", "y", "L", "alpha", "n_dev")})
        ct = tgp.QueryCache.build(g2, **kw)
        with torch.no_grad():
            for x, y in zip(Xa, Ya):
                g2, ct = tgp.add_sample_cached(
                    g2, ct, torch.from_numpy(x), torch.from_numpy(y),
                    fast_update=mode)
            et = err(tgp.query(g2, torch.from_numpy(Xq))[0].numpy(), app64)
        print(f"after {args.appends} appends, fast_update={mode!r}: max "
              f"|mu - mu64| JAX package {ej:.3e}, port {et:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
