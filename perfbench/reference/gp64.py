"""The plain reference: exact GP regression with SquaredExpARD and the data
mean, in float64, from the inputs the benchmark generated.

Plain PyTorch: nothing of the program, no kernel, no cache, no padding.
The training covariance is sf2 exp(-|a/l - b/l|^2 / 2) with the distances
from ``torch.cdist`` (never the expanded product form), and its diagonal
carries the f32 model's training term: noise + 32 2^-23 max(sf2, 1) (the
noise variance, and a jitter that the configuration's f32 state adds).

* ``State``: L = chol(K), Linv = L^-1, Kinv = Linv^T Linv and
  alpha = K^-1 (y - mean(y)) of one data set.
* ``prefix_posterior``: the posterior at query points, each over the
  first m rows of the data (a BO run's earlier states), from one factor:
  forward substitution over a leading block only reads that block, so
  (L^-1 b)[:m] = L[:m, :m]^-1 b[:m].
* ``prefix_posterior_grad``: that posterior with the gradients of its
  mean and variance in the scaled query inputs, by the closed form
  dk_j/dq = -k_j (q - x_j): dmean = sum_j a_j dk_j with
  a = K_m^-1 (y_m - ybar), dvar = -2 sum_j c_j dk_j with c = K_m^-1 k.
* ``lml_grad``: the log marginal likelihood and its gradient in
  theta = [log l (d), log sigma] by the closed form
  dLML/dtheta_j = 1/2 alpha^T dK_j alpha - 1/2 tr(K^-1 dK_j), with the two
  parts apart (each gradient's rounding is judged against them).
* ``rel_max``: max |A - B| / max |B| over a block, A read in row blocks.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
# the f32 model's training-diagonal jitter: 32 f32 epsilons, times sf2 where
# sf2 > 1
JITTER = 32 * 2.0 ** -23


def diag_add(noise: float, sf2: float) -> float:
    return noise + JITTER * max(sf2, 1.0)


def scaled(X: torch.Tensor, log_ell) -> torch.Tensor:
    """The inputs divided by the length-scales, in f64."""
    ell = torch.exp(torch.as_tensor(log_ell, dtype=F64, device=X.device))
    return X.to(F64) / ell


def cov(A: torch.Tensor, B: torch.Tensor, sf2: float) -> torch.Tensor:
    """sf2 exp(-|a - b|^2 / 2) of scaled inputs, in their dtype."""
    d2 = torch.cdist(A, B, compute_mode="donot_use_mm_for_euclid_dist")
    return d2.square_().mul_(-0.5).exp_().mul_(sf2)


def train_cov(Xs: torch.Tensor, sf2: float, noise: float) -> torch.Tensor:
    K = cov(Xs, Xs, sf2)
    K.diagonal().add_(diag_add(noise, sf2))
    return K


class State:
    """The exact GP of one data set: L, Linv, Kinv, alpha (f64), from
    X (n, d), Y (n, 1), theta = [log l (d), log sigma] and the noise."""

    def __init__(self, X, Y, theta, noise: float, inverse: bool = True):
        theta = torch.as_tensor(theta, dtype=F64).cpu()
        d = X.shape[1]
        self.sf2 = math.exp(2.0 * float(theta[d]))
        self.Xs = scaled(X, theta[:d])
        Y = Y.to(F64).reshape(-1, 1)
        self.r = Y - Y.mean()
        K = train_cov(self.Xs, self.sf2, noise)
        self.L = torch.linalg.cholesky(K)
        del K
        self.alpha = torch.cholesky_solve(self.r, self.L)
        self.Linv = self.Kinv = None
        if inverse:
            eye = torch.eye(self.L.shape[0], dtype=F64, device=X.device)
            self.Linv = torch.linalg.solve_triangular(self.L, eye,
                                                      upper=False)
            del eye
            self.Kinv = self.Linv.T @ self.Linv

    def prefix_kinv(self, m: int) -> torch.Tensor:
        """K^-1 of the first m rows: the leading block of Linv is the
        inverse of L's leading block."""
        B = self.Linv[:m, :m]
        return B.T @ B


def prefix_posterior(L: torch.Tensor, Xs: torch.Tensor, Y: torch.Tensor,
                     Qs: torch.Tensor, m, sf2: float):
    """Posterior mean and latent variance at query rows Qs (scaled, f64),
    query i over the first m[i] data rows, from the factor L of all rows:
    (mean (S,), var (S,), z (n, S)) with z[:m_i, i] = L_m^-1 k_i."""
    n = L.shape[0]
    S = Qs.shape[0]
    m = torch.as_tensor(m, device=L.device)
    rows = torch.arange(n, device=L.device)[:, None]
    live = (rows < m[None, :]).to(F64)                     # (n, S)
    k = cov(Xs, Qs, sf2) * live
    z = torch.linalg.solve_triangular(L, k, upper=False) * live
    Y = Y.to(F64).reshape(-1, 1)
    cs = torch.cumsum(Y[:, 0], 0)
    ybar = cs[m - 1] / m.to(F64)                           # (S,)
    w = torch.linalg.solve_triangular(
        L, torch.cat([Y, torch.ones_like(Y)], 1), upper=False)
    mean = ybar + (z * w[:, :1]).sum(0) - ybar * (z * w[:, 1:]).sum(0)
    var = sf2 - (z * z).sum(0)
    del k
    return mean, var, z


def prefix_posterior_grad(L: torch.Tensor, Xs: torch.Tensor,
                          Y: torch.Tensor, Qs: torch.Tensor, m, sf2: float):
    """``prefix_posterior``'s mean and variance at query rows Qs, with
    their gradients in the scaled inputs: (mean (S,), var (S,), dmean
    (S, d), dvar (S, d), k (n, S), c (n, S)), k the masked covariances and
    c = K_m^-1 k.  Back substitution with L^T over a column that is zero
    below m stays zero there and reads L's leading block only, so
    (L^-T v)[:m] = L_m^-T v[:m]."""
    mean, var, z = prefix_posterior(L, Xs, Y, Qs, m, sf2)
    n = L.shape[0]
    m = torch.as_tensor(m, device=L.device)
    live = (torch.arange(n, device=L.device)[:, None] < m[None, :]).to(F64)
    k = cov(Xs, Qs, sf2) * live
    c = torch.linalg.solve_triangular(L.T, z, upper=True)
    Y = Y.to(F64).reshape(-1, 1)
    ybar = torch.cumsum(Y[:, 0], 0)[m - 1] / m.to(F64)
    w = torch.linalg.solve_triangular(
        L, torch.cat([Y, torch.ones_like(Y)], 1), upper=False)
    a = torch.linalg.solve_triangular(
        L.T, live * (w[:, :1] - ybar[None, :] * w[:, 1:]), upper=True)

    def pull(u):
        # sum_j u_j k_j (q - x_j) for every query column
        uk = u * k
        return Qs * uk.sum(0)[:, None] - uk.T @ Xs

    return mean, var, -pull(a), 2.0 * pull(c), k, c


def lml_grad(X, Y, theta, noise: float, rows: int = 1024):
    """(value, grad, value's parts, grad's parts) of the LML at theta in
    f64, with the parts |fit|, |logdet|, the 2 pi term, and per gradient
    entry |1/2 alpha^T dK alpha| + |1/2 tr(K^-1 dK)|."""
    theta = torch.as_tensor(theta, dtype=F64).cpu()
    d = X.shape[1]
    sf2 = math.exp(2.0 * float(theta[d]))
    Xs = scaled(X, theta[:d])
    n = Xs.shape[0]
    Y = Y.to(F64).reshape(-1, 1)
    r = Y - Y.mean()
    K = train_cov(Xs, sf2, noise)
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(r, L)
    fit = -0.5 * float((r * alpha).sum())
    logdet = -float(torch.log(torch.diagonal(L)).sum())
    const = -0.5 * n * math.log(2.0 * math.pi)
    Kinv = torch.cholesky_inverse(L)
    del L
    g_fit = torch.zeros(d + 1, dtype=F64)
    g_ld = torch.zeros(d + 1, dtype=F64)
    a = alpha[:, 0]
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        Ks = cov(Xs[r0:r1], Xs, sf2)                       # (b, n)
        A = a[r0:r1, None] * a[None, :] * Ks
        B = Kinv[r0:r1] * Ks
        for j in range(d):
            D = (Xs[r0:r1, j, None] - Xs[None, :, j]).square_()
            g_fit[j] += 0.5 * float((A * D).sum())
            g_ld[j] -= 0.5 * float((B * D).sum())
        g_fit[d] += float(A.sum())
        g_ld[d] -= float(B.sum())
    if sf2 > 1.0:
        # d diag / d log sigma of the jitter's max(sf2, 1)
        dd = 2.0 * JITTER * sf2
        g_fit[d] += 0.5 * dd * float((a * a).sum())
        g_ld[d] -= 0.5 * dd * float(torch.diagonal(Kinv).sum())
    value = fit + logdet + const
    return (value, g_fit + g_ld, abs(fit) + abs(logdet) + abs(const),
            g_fit.abs() + g_ld.abs())


def rel_max(A: torch.Tensor, B: torch.Tensor, rows: int = 2048) -> float:
    """max |A - B| / max |B| (A in any float type, B f64, same shape),
    reading A in row blocks."""
    n = B.shape[0]
    top = float(B.abs().max())
    worst = 0.0
    for r0 in range(0, n, rows):
        blk = (A[r0:r0 + rows].to(F64) - B[r0:r0 + rows]).abs().max()
        worst = max(worst, float(blk))
    return worst / top
