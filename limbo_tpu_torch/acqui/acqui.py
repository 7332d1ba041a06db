"""Acquisition functions: UCB, GP-UCB, EI and the aggregators (port of
limbo_tpu/acqui/acqui.py).

An acquisition scores a (q, d) batch of candidates, ``acq(gp, X)`` -> (q,),
differentiable end to end through the GP query, so the inner optimizer
ascends it directly.  Aggregators map the (q, p) multi-output mean to (q,)
(limbo FirstElem, bayes_opt/bo_base.hpp:99).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from limbo_tpu_torch.models.dispatch import query_any


def FirstElem(mu: torch.Tensor) -> torch.Tensor:
    """limbo FirstElem aggregator (bo_base.hpp:99)."""
    return mu[:, 0]


def MeanAggregator(mu: torch.Tensor) -> torch.Tensor:
    return torch.mean(mu, dim=1)


def DistanceToTarget(target):
    """Aggregator factory: -|mu - target| (the reference's example custom
    aggregator pattern, e.g. src/examples/obs_multi.cpp)."""
    target = torch.as_tensor(target)

    def agg(mu: torch.Tensor) -> torch.Tensor:
        t = target.to(device=mu.device, dtype=mu.dtype)
        return -torch.sqrt(torch.sum((mu - t) ** 2, dim=1) + 1e-12)

    return agg


@dataclass
class UCB:
    """UCB(x) = agg(mu(x)) + alpha * sigma(x) (acqui/ucb.hpp:74-92;
    default alpha = 0.5)."""

    alpha: float = 0.5

    def __call__(self, gp, X: torch.Tensor, aggregator=FirstElem,
                 iteration=0) -> torch.Tensor:
        mu, var = query_any(gp, X)
        return aggregator(mu) + self.alpha * torch.sqrt(var)


@dataclass
class GP_UCB:
    """GP-UCB with iteration-dependent beta (acqui/gp_ucb.hpp:81-89):
    beta = sqrt(2 log(t^(D/2+2) pi^2 / (3 delta))), default delta = 0.1,
    floored at 0 where limbo's formula is NaN (t = 0).

    ``iteration`` is a Python number (the host loop: beta in f64 on the
    host) or a tensor on the device (the captured loop, whose replays each
    read the count of their own iteration: beta in X's dtype, as the
    reference's traced formula, limbo_tpu/acqui/acqui.py:78-88)."""

    delta: float = 0.1

    def __call__(self, gp, X: torch.Tensor, aggregator=FirstElem,
                 iteration=0) -> torch.Tensor:
        if torch.is_tensor(iteration):
            t = iteration.to(X.dtype)
            nt = torch.pow(torch.clamp(t, min=1e-10), gp.dim_in / 2.0 + 2.0)
            log_arg = torch.clamp(nt * (math.pi ** 2) / (3.0 * self.delta),
                                  min=1.0)
            beta = torch.sqrt(2.0 * torch.log(log_arg))
        else:
            nt = max(float(iteration), 1e-10) ** (gp.dim_in / 2.0 + 2.0)
            log_arg = max(nt * math.pi ** 2 / (3.0 * self.delta), 1.0)
            beta = math.sqrt(2.0 * math.log(log_arg))
        mu, var = query_any(gp, X)
        return aggregator(mu) + beta * torch.sqrt(var)


@dataclass
class EI:
    """Expected improvement with jitter xi (acqui/ei.hpp:76-117):
    EI(x) = (m - f_max - xi) Phi(Z) + s phi(Z), Z = (m - f_max - xi)/s,
    with f_max the best predicted value over the current samples."""

    jitter: float = 0.0

    def best_predicted(self, gp, aggregator=FirstElem) -> torch.Tensor:
        mu_all, _ = query_any(gp, gp.x)                       # (N, p)
        vals = aggregator(mu_all)
        vals = torch.where(gp.mask > 0, vals, torch.full_like(vals,
                                                              -torch.inf))
        return torch.max(vals)

    def __call__(self, gp, X: torch.Tensor, aggregator=FirstElem,
                 iteration=0, f_max=None) -> torch.Tensor:
        mu, var = query_any(gp, X)
        sigma = torch.sqrt(var)
        if f_max is None:
            f_max = self.best_predicted(gp, aggregator)
        Xd = aggregator(mu) - f_max - self.jitter
        Z = Xd / torch.clamp(sigma, min=1e-10)
        phi = torch.exp(-0.5 * Z * Z) / math.sqrt(2.0 * math.pi)
        Phi = 0.5 * torch.erfc(-Z / math.sqrt(2.0))
        ei = Xd * Phi + sigma * phi
        # limbo returns 0 when sigma ~ 0 or no samples yet (ei.hpp:95-97)
        zero = (sigma < 1e-10) | (gp.n_dev < 1)
        return torch.where(zero, torch.zeros_like(ei), ei)
