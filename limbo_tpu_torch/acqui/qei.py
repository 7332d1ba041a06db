"""q-EI: Monte Carlo batch expected improvement, batch BO (port of
limbo_tpu/acqui/qei.py).

No limbo counterpart (limbo proposes one point per iteration).  The joint
posterior of a q-point batch is one masked solve against the training
factor; the estimate uses reparameterized base normals, fixed for one
optimization, so qEI is smooth and differentiable in the whole (q, d)
batch, which the gradient ascent climbs.  Batches carry any leading batch
axes: the restarts of ``propose_batch`` are one (R, q, d) tensor, so one
cross-covariance of R q rows against the training set serves them all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from limbo_tpu_torch.acqui.acqui import EI, FirstElem
from limbo_tpu_torch.opt.base import take
from limbo_tpu_torch.utils.precision import solve_triangular


def joint_posterior(gp, Xb: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint posterior of (..., q, d) batches: the mean (..., q) of the
    first output and the covariance (..., q, q), from the training Cholesky
    factor at the GP's live count, with a 1e-6 jitter on the diagonal."""
    Xb = torch.as_tensor(Xb, device=gp.x.device).to(gp.x.dtype)
    if Xb.ndim == 1:
        Xb = Xb[None, :]
    batch, (q, d) = Xb.shape[:-2], Xb.shape[-2:]
    X = Xb.reshape(-1, d)                                     # (B q, d)
    ks = gp.kernel.gram(X, gp.x) * gp.mask[None, :]           # (B q, N)
    mu = (ks @ gp.alpha + gp.mean(X))[:, 0].reshape(*batch, q)
    V = solve_triangular(gp.L, ks.T, upper=False)  # (N, B q)
    B = X.shape[0] // q
    V = V.reshape(-1, B, q)
    K = gp.kernel.gram(X, X).reshape(B, q, B, q)
    Kqq = torch.diagonal(K, dim1=0, dim2=2).permute(2, 0, 1)  # (B, q, q)
    cov = Kqq - torch.einsum("nbi,nbj->bij", V, V)
    cov = cov + 1e-6 * torch.eye(q, dtype=cov.dtype, device=cov.device)
    return mu, cov.reshape(*batch, q, q)


def joint_posterior_multi(m, Xb: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint posterior of (..., q, d) batches under a MultiGP: the mean
    (..., q, p) and each objective's covariance (..., p, q, q).  The
    objectives are independent GPs (limbo bo_multi.hpp:153), so the joint
    law is p separate (q, q) Gaussians.  Feeds ops.ehvi.qehvi_exact_max."""
    Xb = torch.as_tensor(Xb, device=m.gps[0].x.device).to(m.gps[0].x.dtype)
    if Xb.ndim == 1:
        Xb = Xb[None, :]
    out = [joint_posterior(g, Xb) for g in m.gps]
    mus = torch.stack([o[0] for o in out], dim=-1)            # (..., q, p)
    covs = torch.stack([o[1] for o in out], dim=-3)           # (..., p, q, q)
    d = Xb.shape[-1]
    mean = m.mean(Xb.reshape(-1, d)).reshape(mus.shape)
    return mus + mean, covs


@dataclass
class QEI:
    """Monte Carlo q-EI with reparameterized base samples:
    qEI(X) = E[ max_i (f(x_i) - f_max)^+ ] under the joint posterior."""

    n_samples: int = 128
    jitter: float = 0.0

    def __call__(self, gp, Xb: torch.Tensor, base: torch.Tensor,
                 aggregator=FirstElem, f_max: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """Xb: (..., q, d) candidate batches; base: (n_samples, q) N(0, 1)
        draws.  Returns (...)."""
        if f_max is None:
            with torch.no_grad():
                f_max = EI().best_predicted(gp, aggregator)
        mu, cov = joint_posterior(gp, Xb)
        Lq = torch.linalg.cholesky_ex(cov).L
        draws = mu[..., None, :] + base @ Lq.mT               # (..., S, q)
        imp = torch.amax(draws, dim=-1) - f_max - self.jitter
        return torch.mean(torch.maximum(imp, torch.zeros_like(imp)), dim=-1)


def propose_batch(gp, q: int, generator: torch.Generator,
                  qei: Optional[QEI] = None, restarts: int = 16,
                  steps: int = 30, aggregator=FirstElem
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximize qEI over a (q, d) batch by multi-start gradient ascent:
    ``restarts`` uniform starts in [0, 1]^(q d) ascended together by
    Rprop(``steps``).  Returns (the best batch (q, d), its qEI), on the
    GP's device, with nothing read back."""
    qei = qei if qei is not None else QEI()
    kw = dict(generator=generator, dtype=gp.x.dtype, device=gp.x.device)
    base = torch.randn((qei.n_samples, q), **kw)
    inits = torch.rand((restarts, q * gp.dim_in), **kw)
    return propose_batch_from(gp, q, base, inits, qei, steps, aggregator)


def propose_batch_from(gp, q: int, base: torch.Tensor, inits: torch.Tensor,
                       qei: Optional[QEI] = None, steps: int = 30,
                       aggregator=FirstElem
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic rest of ``propose_batch``, given its draws: the
    base normals (n_samples, q) and the starts (restarts, q d)."""
    from limbo_tpu_torch.opt.gradient import Rprop

    qei = qei if qei is not None else QEI()
    d = gp.dim_in
    with torch.no_grad():
        f_max = EI().best_predicted(gp, aggregator)

    def objective(flat):
        return qei(gp, flat.reshape(-1, q, d), base, aggregator, f_max=f_max)

    res = Rprop(iterations=steps)(objective, inits, None, True)
    i = torch.argmax(res.value)
    return take(res.x, i).reshape(q, d), take(res.value, i)
