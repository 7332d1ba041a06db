"""How far the cached posterior is from the exact one, in the port and in
the JAX package, on the same data.

bench.py's workload (SquaredExpARD with l = 1, sigma^2 = 1, noise 0.01;
DataMean; d = 8; points uniform in the unit cube; y = sin(3 sum x) + 0.1 e)
at n = 512 and 2048, in f32 on the CPU through the stock paths (library
Cholesky and triangular solve, no Pallas): fit, QueryCache.build with the
f32 master K^-1 and with the bf16 mirror, then query_cached at 64 points.
Each mean and variance is held against the f64 posterior of the same data
(numpy/scipy, none of either package's code).  The port's gap must be no
worse than twice the reference's plus a floor (1e-4 for the mean, 1e-3 for
the variance).  The gaps are printed (``pytest -s``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sl
import torch

import limbo_tpu.kernels as jk
import limbo_tpu.means as jm
from limbo_tpu.models import gp as jgp
from limbo_tpu_torch import kernels, means
from limbo_tpu_torch.models import gp as tgp

torch.set_num_threads(1)

_jfit = jax.jit(jgp.fit, static_argnames=("capacity",))
_jbuild = jax.jit(jgp.QueryCache.build, static_argnames=("qdtype",))
_jquery_cached = jax.jit(jgp.query_cached)

D, Q = 8, 64
# the f32 model's training diagonal: noise + 32 f32 eps (sigma^2 = 1)
DIAG_ADD = 0.01 + 32 * 2.0 ** -23


def _posterior_f64(X, Y, Xq):
    def r2(A, B):
        return ((A[:, None, :] - B[None, :, :]) ** 2).sum(axis=-1)

    K = np.exp(-0.5 * r2(X, X))
    K[np.diag_indices_from(K)] += DIAG_ADD
    L = np.linalg.cholesky(K)
    ybar = Y.mean(axis=0)
    alpha = sl.cho_solve((L, True), Y - ybar)
    ks = np.exp(-0.5 * r2(Xq, X))
    z = sl.solve_triangular(L, ks.T, lower=True)
    return (ks @ alpha + ybar)[:, 0], np.maximum(1.0 - (z * z).sum(0), 0.0)


@pytest.mark.parametrize("n", [512, 2048])
def test_cached_posterior_gap_no_worse_than_reference(n):
    rng = np.random.default_rng(n)
    X = rng.uniform(size=(n, D)).astype(np.float32)
    Y = (np.sin(3.0 * X.sum(axis=1, keepdims=True))
         + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    Xq = rng.uniform(size=(Q, D)).astype(np.float32)
    mu64, var64 = _posterior_f64(X.astype(np.float64), Y.astype(np.float64),
                                 Xq.astype(np.float64))

    gj = _jfit(jk.SquaredExpARD.create(dim=D, dtype=jnp.float32),
               jm.DataMean.create(dtype=jnp.float32), jnp.asarray(X),
               jnp.asarray(Y), capacity=n)
    gt = tgp.fit(kernels.SquaredExpARD.create(dim=D, device="cpu"),
                 means.DataMean.create(device="cpu"), X, Y, capacity=n,
                 device="cpu")
    for name, jq, tq in (("f32 master", None, None),
                         ("bf16 mirror", jnp.bfloat16, torch.bfloat16)):
        mj, vj = _jquery_cached(gj, _jbuild(gj, qdtype=jq), jnp.asarray(Xq))
        mt, vt = tgp.query_cached(gt, tgp.QueryCache.build(gt, qdtype=tq),
                                  torch.from_numpy(Xq))
        gap = dict(
            mu_ref=np.abs(np.asarray(mj, np.float64)[:, 0] - mu64).max(),
            mu_port=np.abs(mt[:, 0].double().numpy() - mu64).max(),
            var_ref=np.abs(np.asarray(vj, np.float64) - var64).max(),
            var_port=np.abs(vt.double().numpy() - var64).max())
        print(f"n={n} {name}: max |mu - mu64| reference {gap['mu_ref']:.3e},"
              f" port {gap['mu_port']:.3e}; max |var - var64| reference "
              f"{gap['var_ref']:.3e}, port {gap['var_port']:.3e}")
        assert gap["mu_port"] <= 2.0 * gap["mu_ref"] + 1e-4, (name, gap)
        assert gap["var_port"] <= 2.0 * gap["var_ref"] + 1e-3, (name, gap)
