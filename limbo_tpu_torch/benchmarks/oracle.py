"""Float64 NumPy exact-GP oracle for the regression benchmark (the port's
own copy of limbo_tpu/benchmarks/oracle.py, which it must not import).

The reference's regression claims rest on measured comparisons against GPy
and libGP (src/benchmarks/regression/gpy.py, docs/benchmark_res_reg.inc:3-5).
Neither ships in this image, so the external baseline is this self-contained
f64 CPU implementation of the *same* model and protocol the suite runs:
SE-ARD kernel (+ optional noise optimization), log-space hyperparameters,
LML maximized by Rprop with limbo's constants (opt/rprop.hpp:82: delta0=0.1,
eta-=0.5, eta+=1.2) and the reference's hand-derived gradient form
(gp.hpp:285-313: dLML/dtheta = 1/2 tr((alpha alpha^T - K^{-1}) dK/dtheta)).

It is deliberately NumPy/BLAS-only — an honest stand-in for the
"Eigen-class single-host f64 library" cost model — and doubles as a
numerical ground truth for the f32 path (MSE parity within noise).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

JITTER = 1e-8


@dataclass
class OracleGP:
    """Fitted state: data + hyperparameters + Cholesky factor."""

    X: np.ndarray           # (n, d)
    Y: np.ndarray           # (n, 1)
    log_ell: np.ndarray     # (d,)
    log_sf: float           # log signal std
    log_noise: float        # log noise std
    L: np.ndarray           # (n, n)
    alpha: np.ndarray       # (n, 1)


def _gram(X1, X2, log_ell, log_sf):
    ell = np.exp(log_ell)
    D = (X1[:, None, :] - X2[None, :, :]) / ell[None, None, :]
    sq = np.sum(D * D, axis=-1)
    return np.exp(2.0 * log_sf) * np.exp(-0.5 * sq)


def _nll_and_grad(params, X, Y, optimize_noise):
    n, d = X.shape
    log_ell = params[:d]
    log_sf = params[d]
    log_noise = params[d + 1] if optimize_noise else params[-1]
    K = _gram(X, X, log_ell, log_sf)
    noise_var = math.exp(2.0 * log_noise)
    Kn = K + (noise_var + JITTER) * np.eye(n)
    L = np.linalg.cholesky(Kn)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, Y))
    lml = (-0.5 * float(np.sum(Y * alpha))
           - np.sum(np.log(np.diag(L)))
           - 0.5 * n * math.log(2 * math.pi))
    # W = alpha alpha^T - K^{-1}  (gp.hpp:285-313)
    Kinv = np.linalg.solve(L.T, np.linalg.solve(L, np.eye(n)))
    W = alpha @ alpha.T - Kinv
    ell = np.exp(log_ell)
    grads = np.empty_like(params)
    for j in range(d):
        Dj = (X[:, j:j + 1] - X[None, :, j]) / ell[j]
        # dK/dlog_ell_j = K * Dj^2
        grads[j] = 0.5 * np.sum(W * (K * (Dj * Dj)))
    grads[d] = 0.5 * np.sum(W * (2.0 * K))          # dK/dlog_sf = 2K
    if optimize_noise:
        grads[d + 1] = 0.5 * np.trace(W) * 2.0 * noise_var
    return lml, grads, L, alpha


def fit(X: np.ndarray, Y: np.ndarray, optimize_noise: bool = True,
        iterations: int = 50, eps_stop: float = 1e-2,
        init_log_noise: float = math.log(0.01)) -> OracleGP:
    """SE-ARD GP fit with Rprop hyperparameter learning (limbo constants)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64).reshape(len(X), 1)
    n, d = X.shape
    params = np.zeros(d + (2 if optimize_noise else 1))
    if optimize_noise:
        params[d + 1] = init_log_noise
    delta = np.full_like(params, 0.1)
    grad_old = np.zeros_like(params)
    best = (-np.inf, params.copy())
    noise_fixed = init_log_noise
    for _ in range(iterations):
        p_eval = params if optimize_noise else np.append(params, noise_fixed)
        lml, g, _, _ = _nll_and_grad(p_eval, X, Y, optimize_noise)
        g = g[:len(params)]
        if lml > best[0]:
            best = (lml, params.copy())
        prod = grad_old * g
        delta = np.where(prod > 0, np.minimum(delta * 1.2, 50.0),
                         np.where(prod < 0, np.maximum(delta * 0.5, 1e-6),
                                  delta))
        g_eff = np.where(prod < 0, 0.0, g)
        params = params + np.sign(g_eff) * delta
        grad_old = g_eff
        if np.linalg.norm(g_eff) < eps_stop:
            break
    p_eval = params if optimize_noise else np.append(params, noise_fixed)
    lml, _, _, _ = _nll_and_grad(p_eval, X, Y, optimize_noise)
    if lml < best[0]:
        params = best[1]
        p_eval = params if optimize_noise else np.append(params, noise_fixed)
    _, _, L, alpha = _nll_and_grad(p_eval, X, Y, optimize_noise)
    log_ell = p_eval[:d]
    return OracleGP(X=X, Y=Y, log_ell=log_ell, log_sf=p_eval[d],
                    log_noise=p_eval[d + 1] if optimize_noise else noise_fixed,
                    L=L, alpha=alpha)


def query(gp: OracleGP, Xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    Xq = np.asarray(Xq, dtype=np.float64)
    ks = _gram(Xq, gp.X, gp.log_ell, gp.log_sf)
    mu = ks @ gp.alpha
    z = np.linalg.solve(gp.L, ks.T)
    var = np.exp(2.0 * gp.log_sf) - np.sum(z * z, axis=0)
    return mu, np.maximum(var, 0.0)


def fit_and_eval(X, Y, Xq, Yq, optimize_noise=True
                 ) -> Tuple[float, float, float]:
    """(mse, learn_s, query_s) under the benchmark protocol."""
    t0 = time.perf_counter()
    gp = fit(X, Y, optimize_noise=optimize_noise)
    t_learn = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu, _ = query(gp, Xq)
    t_query = time.perf_counter() - t0
    mse = float(np.mean((mu - np.asarray(Yq).reshape(-1, 1)) ** 2))
    return mse, t_learn, t_query
