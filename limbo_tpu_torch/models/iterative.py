"""Iterative (matvec-based) GP for large n (port of
limbo_tpu/models/iterative.py): the 10k-50k scaling path.

The covariance is never materialized: K alpha = y is solved by conjugate
gradients whose matvec builds row blocks of the gram matrix on the fly
(GPyTorch-style blackbox matrix-matrix inference, Gardner et al. 2018), so
memory is O(n * block) and every block is the gram kernel on the card once
block * n >= 512^2 (ops/gram_pallas.use_pallas).

* ``blocked_kernel_matvec``: (K_masked + (noise + jitter) I) V, one
  ``kernel.gram(rows, X)`` and one product per row block, written into a
  preallocated output.
* ``cg_solve``: batched CG over the columns of B, a ``torch.autograd.
  Function`` whose backward is one more CG solve on the cotangent (the
  implicit-function pullback of the reference's custom VJP, :95-127), so
  no iterate is kept for the backward; no gradient reaches the matvec's
  parameters and the residual norms are not differentiable.
* The reference's early exit (a ``while_loop`` on any column above
  tol * |b|) is a host read in eager PyTorch.  Converged columns freeze
  (their step is multiplied by 0), so iterations past convergence leave
  the iterate's bits unchanged: the loop reads the test from the card once
  every ``CG_CHECK_EVERY`` iterations and stops there, with the reference's
  result.

Predictive variance uses CG too: sigma^2(x) = k(x,x) - k_x^T K^{-1} k_x.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple

import torch

from limbo_tpu_torch.kernels.base import JITTER
from limbo_tpu_torch.means.means import prepare_mean
from limbo_tpu_torch.models.gp import _clamp0
from limbo_tpu_torch.utils.device import resolve_device

# iterations between two host reads of the convergence test
CG_CHECK_EVERY = 8


def blocked_kernel_matvec(kernel, X: torch.Tensor, mask: torch.Tensor,
                          noise_var, V: torch.Tensor,
                          block: int = 2048) -> torch.Tensor:
    """(K_masked + (noise + jitter) I) @ V without materializing K.

    X: (n, d) padded; mask: (n,); V: (n, q).  Row block i of the gram
    matrix is built, multiplied into rows i of the output and dropped."""
    n = X.shape[0]
    nb = -(-n // block)
    Xp = torch.zeros((nb * block, X.shape[1]), dtype=X.dtype,
                     device=X.device)
    Xp[:n] = X
    maskp = torch.zeros((nb * block,), dtype=X.dtype, device=X.device)
    maskp[:n] = mask
    Vm = V * mask[:, None]
    out = torch.empty((nb * block, V.shape[1]), dtype=V.dtype,
                      device=V.device)
    for i in range(nb):
        r = slice(i * block, (i + 1) * block)
        G = kernel.gram(Xp[r], X) * mask[None, :] * maskp[r, None]
        out[r] = G @ Vm
    # diagonal: (K_ii + noise + jitter) for valid rows, identity for padding
    diag = (noise_var + JITTER) * mask + (1.0 - mask)
    return out[:n] + diag[:, None] * V


def _cg_solve_impl(matvec: Callable, B: torch.Tensor, tol: float,
                   maxiter: int):
    """(X, residual norms, iterations with a column still active)."""
    X = torch.zeros_like(B)
    R, P = B.clone(), B.clone()
    rs = torch.sum(R * R, dim=0)
    bnorm = torch.clamp(torch.sqrt(torch.sum(B * B, dim=0)), min=1e-30)
    iters = torch.zeros((), dtype=torch.int64, device=B.device)
    for it in range(maxiter):
        if it % CG_CHECK_EVERY == 0 and not bool(
                torch.any(torch.sqrt(rs) > tol * bnorm)):
            break
        KP = matvec(P)
        denom = torch.sum(P * KP, dim=0)
        active = (torch.sqrt(rs) > tol * bnorm).to(B.dtype)
        alpha = rs / torch.clamp(denom, min=1e-30) * active
        iters += active.max().to(torch.int64)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * KP
        rs_new = torch.sum(R * R, dim=0)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        P = R + beta[None, :] * P
        rs = rs_new
    return X, torch.sqrt(rs), iters


class _CGSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, B, matvec, tol, maxiter):
        X, rnorm, _ = _cg_solve_impl(matvec, B, tol, maxiter)
        ctx.matvec, ctx.tol, ctx.maxiter = matvec, tol, maxiter
        ctx.mark_non_differentiable(rnorm)
        return X, rnorm

    @staticmethod
    def backward(ctx, Xbar, _rbar):
        if Xbar is None:
            return None, None, None, None
        Bbar, _, _ = _cg_solve_impl(ctx.matvec, Xbar, ctx.tol, ctx.maxiter)
        return Bbar, None, None, None


def cg_solve(matvec: Callable, B: torch.Tensor, tol: float = 1e-6,
             maxiter: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched conjugate gradients for an SPD system, multi-RHS.

    B: (n, q).  Returns (X, residual_norms).  Differentiable in B by the
    implicit function theorem: for X = A^{-1} B with A symmetric the
    pullback is A^{-1} Xbar, one more CG solve.  No gradient flows into
    ``matvec``'s parameters (hp-opt of this family refits instead), and the
    residual norms are a diagnostic without a gradient."""
    return _CGSolve.apply(B, matvec, tol, maxiter)


@dataclass
class IterativeGP:
    """Large-n GP state: data and the CG-solved alpha (no Cholesky factor).
    ``cg_iters`` / ``cg_residual``: the iterations and residual norms of
    the solve that made alpha (None before one)."""

    kernel: object
    mean: object
    x: torch.Tensor
    y: torch.Tensor
    n: int
    alpha: torch.Tensor
    block: int = 2048
    cg_tol: float = 1e-5
    cg_maxiter: int = 256
    cg_iters: Optional[torch.Tensor] = None
    cg_residual: Optional[torch.Tensor] = None

    replace = replace

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dim_in(self) -> int:
        return self.x.shape[1]

    @property
    def dim_out(self) -> int:
        return self.y.shape[1]

    @property
    def mask(self) -> torch.Tensor:
        return (torch.arange(self.capacity, device=self.x.device)
                < self.n).to(self.x.dtype)

    @property
    def n_dev(self) -> torch.Tensor:
        """n as a 0-d int64 tensor on x's device (the GP's protocol)."""
        return torch.full((), self.n, dtype=torch.int64, device=self.x.device)


def _matvec(gp: IterativeGP, mask: torch.Tensor) -> Callable:
    return lambda V: blocked_kernel_matvec(gp.kernel, gp.x, mask,
                                           gp.kernel.noise, V, gp.block)


def _solve_alpha(gp: IterativeGP) -> IterativeGP:
    """The data mean refreshed and alpha solved by CG from zero."""
    mask = gp.mask
    mean = prepare_mean(gp.mean, gp.y, mask)
    centered = (gp.y - mean(gp.x)) * mask[:, None]
    gp = gp.replace(mean=mean)
    with torch.no_grad():
        alpha, rnorm, iters = _cg_solve_impl(_matvec(gp, mask), centered,
                                             gp.cg_tol, gp.cg_maxiter)
    return gp.replace(alpha=alpha, cg_iters=iters, cg_residual=rnorm)


def fit(kernel, mean, X, Y, capacity: Optional[int] = None,
        block: int = 2048, cg_tol: float = 1e-5, cg_maxiter: int = 256,
        device="cuda", dtype=None) -> IterativeGP:
    """Pad and solve alpha by CG (limbo_tpu/models/iterative.py:157-176);
    capacity defaults to n rounded up to whole blocks."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    dtype = dtype if dtype is not None else (
        X.dtype if X.is_floating_point() else torch.float32)
    X = torch.atleast_2d(X.to(dtype))
    Y = torch.atleast_2d(torch.as_tensor(Y, device=dev).to(dtype))
    n, d = X.shape
    N = capacity if capacity is not None else -(-n // block) * block
    xp = torch.zeros((N, d), dtype=dtype, device=dev)
    xp[:n] = X
    yp = torch.zeros((N, Y.shape[1]), dtype=dtype, device=dev)
    yp[:n] = Y
    gp = IterativeGP(kernel=kernel, mean=mean, x=xp, y=yp, n=n,
                     alpha=torch.zeros_like(yp), block=block, cg_tol=cg_tol,
                     cg_maxiter=cg_maxiter)
    return _solve_alpha(gp)


def empty(kernel, mean, dim_in: int, dim_out: int = 1, capacity: int = 256,
          device="cuda", dtype=torch.float32, block: int = 2048,
          cg_tol: float = 1e-5, cg_maxiter: int = 256) -> IterativeGP:
    """An IterativeGP with no samples (the BO loop's model slot); the
    block is at most the capacity."""
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    return IterativeGP(kernel=kernel, mean=mean,
                       x=torch.zeros((capacity, dim_in), **kw),
                       y=torch.zeros((capacity, dim_out), **kw), n=0,
                       alpha=torch.zeros((capacity, dim_out), **kw),
                       block=min(block, capacity), cg_tol=cg_tol,
                       cg_maxiter=cg_maxiter)


def add_sample(gp: IterativeGP, x_new, y_new) -> IterativeGP:
    """Append one sample without re-solving: row n of x and y is written in
    place and alpha goes stale until ``refit`` (the BO loop refits every
    model_refit_period iterations)."""
    i = gp.n
    if i >= gp.capacity:
        raise ValueError(f"GP is full (capacity {gp.capacity})")
    gp.x[i] = torch.as_tensor(x_new, dtype=gp.x.dtype, device=gp.x.device)
    gp.y[i] = torch.as_tensor(y_new, dtype=gp.y.dtype, device=gp.y.device)
    return gp.replace(n=i + 1)


def refit(gp: IterativeGP) -> IterativeGP:
    """Re-solve alpha by CG from the current (padded) dataset.  As the
    reference's code does, CG starts from zero (its docstring's warm start
    from the stale alpha is not what it runs)."""
    return _solve_alpha(gp)


def query(gp: IterativeGP, Xq, compute_variance: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior moments; the variance is one batched CG over the query
    columns, differentiable in Xq (compute_variance=False gives zeros)."""
    Xq = torch.atleast_2d(torch.as_tensor(Xq, device=gp.x.device)
                          ).to(gp.x.dtype)
    mask = gp.mask
    ks = gp.kernel.gram(Xq, gp.x) * mask[None, :]                  # (q, N)
    mu = ks @ gp.alpha + gp.mean(Xq)
    if not compute_variance:
        return mu, torch.zeros((Xq.shape[0],), dtype=gp.x.dtype,
                               device=gp.x.device)
    Z, _ = cg_solve(_matvec(gp, mask), ks.T, gp.cg_tol, gp.cg_maxiter)
    var = gp.kernel.k_diag(Xq) - torch.sum(ks.T * Z, dim=0)
    return mu, _clamp0(var)
