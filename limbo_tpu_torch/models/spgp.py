"""SPGP: Sparse Pseudo-input GP (Snelson & Ghahramani, NIPS 2005; port of
limbo_tpu/models/spgp.py).

Reference capability: src/limbo/experimental/model/spgp.hpp:86, m
pseudo-inputs (default 10% of the data), O(n m^2) training, joint
optimization of {pseudo-inputs, kernel parameters, noise}.  The FITC
negative log marginal likelihood is a differentiable scalar of the flat
vector [xb (m*d), kernel params]; autograd replaces limbo's hand-written
gradients and a Rprop ascent replaces its LBFGS.  On the card the two
cross-covariances are the gram kernel once n * m >= 512^2.

A failed factor (``jnp.linalg.cholesky`` returns NaN where
``torch.linalg.cholesky`` raises) comes from ``cholesky_ex`` as NaN, so a
bad step of the ascent loses, as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import torch

from limbo_tpu_torch.means.means import prepare_mean
from limbo_tpu_torch.models.gp import _clamp0, _round_capacity
from limbo_tpu_torch.opt.gradient import Rprop
from limbo_tpu_torch.utils.device import resolve_device

DEFAULT_RATIO = 0.1   # limbo defaults::model_spgp pseudo-input ratio
_MJITTER = 1e-6


@dataclass
class SPGP:
    """Padded SPGP state.

    kernel: covariance with its parameters; its noise is the FITC noise
    (limbo's ``sig``, spgp.hpp:95).  xb: (m, d) pseudo-inputs.  x, y, n as
    in gp.GP (n a Python int).
    """

    kernel: object
    mean: object
    x: torch.Tensor
    y: torch.Tensor
    n: int
    xb: torch.Tensor

    replace = replace

    @property
    def m(self) -> int:
        return self.xb.shape[0]

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


def _cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower factor, all NaN where A is not positive definite (no host
    read; differentiable)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, math.nan))


def _tri_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=False)


def _fitc_terms(kernel, xb, X, Yc, mask, noise_var):
    """Shared FITC quantities.  Yc: centered observations (N, p), masked."""
    m = xb.shape[0]
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    Kmm = kernel.gram(xb, xb) + _MJITTER * eye
    Knm = kernel.gram(X, xb) * mask[:, None]                   # (N, m)
    Lm = _cholesky_nan(Kmm)
    V = _tri_solve(Lm, Knm.T)                                  # (m, N)
    q_diag = torch.sum(V * V, dim=0)                           # (N,)
    lam = kernel.k_diag(X) - q_diag + noise_var                # (N,)
    lam = torch.where(mask > 0, torch.clamp(lam, min=1e-12),
                      torch.ones_like(lam))
    Vs = V / torch.sqrt(lam)[None, :]                          # scaled
    La = _cholesky_nan(eye + Vs @ Vs.T)
    ys = Yc / torch.sqrt(lam)[:, None]                         # (N, p)
    beta = _tri_solve(La, Vs @ ys)                             # (m, p)
    return Lm, La, Vs, lam, ys, beta


def neg_log_marginal_likelihood(kernel, mean, xb, X, Y, n) -> torch.Tensor:
    """FITC NLML, differentiable in (kernel parameters, xb): the training
    objective (spgp.hpp _optimize_hyperparams:409)."""
    N = X.shape[0]
    n = int(n)
    mask = (torch.arange(N, device=X.device) < n).to(X.dtype)
    mean = prepare_mean(mean, Y, mask)
    Yc = (Y - mean(X)) * mask[:, None]
    _, La, _, lam, ys, beta = _fitc_terms(kernel, xb, X, Yc, mask,
                                          kernel.noise)
    p = Y.shape[1]
    data = 0.5 * (torch.sum(ys * ys) - torch.sum(beta * beta))
    logdet = (torch.sum(torch.log(lam) * mask)
              + 2.0 * torch.sum(torch.log(torch.diagonal(La))))
    return data + 0.5 * p * logdet + 0.5 * n * p * math.log(2 * math.pi)


def _padded(X, Y, capacity, device, dtype):
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    dtype = dtype if dtype is not None else (
        X.dtype if X.is_floating_point() else torch.float32)
    X = torch.atleast_2d(X.to(dtype))
    Y = torch.atleast_2d(torch.as_tensor(Y, device=dev).to(dtype))
    n, d = X.shape
    N = capacity if capacity is not None else _round_capacity(n)
    xpad = torch.zeros((N, d), dtype=dtype, device=dev)
    xpad[:n] = X
    ypad = torch.zeros((N, Y.shape[1]), dtype=dtype, device=dev)
    ypad[:n] = Y
    return X, xpad, ypad, n


def fit(kernel, mean, X, Y, m: Optional[int] = None,
        capacity: Optional[int] = None, generator=None, xb=None,
        device="cuda", dtype=None) -> SPGP:
    """The SPGP state with pseudo-inputs on m distinct samples (limbo
    initializes xb from the data; m defaults to max(2, ceil(0.1 n))), drawn
    from ``generator`` unless ``xb`` (m, d) is given."""
    X, xpad, ypad, n = _padded(X, Y, capacity, device, dtype)
    m = m if m is not None else max(2, int(math.ceil(DEFAULT_RATIO * n)))
    if xb is None:
        idx = torch.randperm(n, generator=generator, device=X.device)[:m]
        xb = X[idx]
    xb = torch.as_tensor(xb, dtype=X.dtype, device=X.device)
    mask = (torch.arange(xpad.shape[0], device=X.device) < n).to(X.dtype)
    return SPGP(kernel=kernel, mean=prepare_mean(mean, ypad, mask), x=xpad,
                y=ypad, n=n, xb=xb)


def empty(kernel, mean, dim_in: int, dim_out: int = 1, m: int = 16,
          capacity: int = 256, device="cuda", dtype=torch.float32,
          generator=None) -> SPGP:
    """An SPGP with no samples (the BO loop's model slot): pseudo-inputs
    uniform in [0, 1]^d from ``generator``, refined by SPGPHpOpt."""
    dev = resolve_device(device)
    return SPGP(kernel=kernel, mean=mean,
                x=torch.zeros((capacity, dim_in), dtype=dtype, device=dev),
                y=torch.zeros((capacity, dim_out), dtype=dtype, device=dev),
                n=0, xb=torch.rand((m, dim_in), generator=generator,
                                   dtype=dtype, device=dev))


def add_sample(sp: SPGP, x_new, y_new) -> SPGP:
    """Append one sample: row n of x and y written in place, n + 1, the
    data mean refreshed.  The FITC terms are recomputed at every query
    (spgp.hpp keeps no per-sample factor either)."""
    i = sp.n
    if i >= sp.capacity:
        raise ValueError(f"SPGP is full (capacity {sp.capacity})")
    sp.x[i] = torch.as_tensor(x_new, dtype=sp.x.dtype, device=sp.x.device)
    sp.y[i] = torch.as_tensor(y_new, dtype=sp.y.dtype, device=sp.y.device)
    sp2 = sp.replace(n=i + 1)
    return sp2.replace(mean=prepare_mean(sp2.mean, sp2.y, sp2.mask))


def query(sp: SPGP, Xq) -> Tuple[torch.Tensor, torch.Tensor]:
    """FITC predictive moments (spgp.hpp predict/query:193): the mean
    through the Lm / La factors, the variance latent plus the FITC
    correction, clamped at 0."""
    Xq = torch.atleast_2d(torch.as_tensor(Xq, device=sp.x.device)
                          ).to(sp.x.dtype)
    mask = sp.mask
    Yc = (sp.y - sp.mean(sp.x)) * mask[:, None]
    Lm, La, _, _, _, beta = _fitc_terms(sp.kernel, sp.xb, sp.x, Yc, mask,
                                        sp.kernel.noise)
    lq = _tri_solve(Lm, sp.kernel.gram(sp.xb, Xq))              # (m, q)
    lq2 = _tri_solve(La, lq)                                    # (m, q)
    mu = lq2.T @ beta + sp.mean(Xq)                             # (q, p)
    var = (sp.kernel.k_diag(Xq) - torch.sum(lq * lq, dim=0)
           + torch.sum(lq2 * lq2, dim=0))
    return mu, _clamp0(var)


@dataclass
class SPGPHpOpt:
    """Joint optimization of the pseudo-inputs, kernel parameters and noise
    (limbo uses NLOpt LD_LBFGS, spgp.hpp:85): Rprop ascends the negated
    NLML of the flat vector [xb, kernel params]."""

    optimizer: object = field(default_factory=lambda: Rprop(iterations=200))

    def __call__(self, sp: SPGP, generator=None) -> SPGP:
        m, d = sp.xb.shape

        def unpack(p):
            return p[:m * d].reshape(m, d), sp.kernel.with_params(p[m * d:])

        def objective(P):
            out = []
            for p in P:
                xb, kernel = unpack(p)
                out.append(-neg_log_marginal_likelihood(
                    kernel, sp.mean, xb, sp.x, sp.y, sp.n))
            return torch.stack(out)

        init = torch.cat([sp.xb.reshape(-1), sp.kernel.params.to(sp.xb)])
        res = self.optimizer(objective, init, generator, bounded=False)
        xb, kernel = unpack(res.x.detach())
        return sp.replace(xb=xb, kernel=kernel)
