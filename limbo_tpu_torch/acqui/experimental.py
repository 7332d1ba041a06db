"""Experimental acquisition functions: the EHVI wrapper and UCB_IMGPO (port
of limbo_tpu/acqui/experimental.py).

Reference: src/limbo/experimental/acqui/{ehvi,ucb_imgpo,eci}.hpp (ECI lives
with the constrained optimizer, bo/cbo.py).  Both score a (q, d) batch of
candidates, ``acq(model, X)`` -> (q,), as the port's other acquisitions do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from limbo_tpu_torch.acqui.acqui import FirstElem
from limbo_tpu_torch.models import multi_gp
from limbo_tpu_torch.ops.ehvi import ehvi_max


@dataclass
class EhviAcqui:
    """Exact EHVI over a MultiGP, 2 or 3 objectives (experimental/acqui/
    ehvi.hpp:59, which calls the native ehvi2d; here the closed-form box
    decomposition, differentiable through the query).

    front: (k, p) observed Pareto front (padded; front_mask marks the
    valid rows), ref: (p,) reference point."""

    front: torch.Tensor
    ref: torch.Tensor
    front_mask: Optional[torch.Tensor] = None

    def __call__(self, model: multi_gp.MultiGP, X: torch.Tensor,
                 aggregator=FirstElem, iteration=0) -> torch.Tensor:
        mu, var = multi_gp.query(model, X)
        sigma = torch.sqrt(torch.clamp(var, min=1e-20))
        return ehvi_max(mu, sigma, self.front, self.ref,
                        front_mask=self.front_mask)


@dataclass
class UCB_IMGPO:
    """The UCB variant of IMGPO (experimental/acqui/ucb_imgpo.hpp:62):

    a(x) = mu(x) + (sqrt(2 log(pi^2 M^2 / (12 nu))) + 0.2) * sigma(x),
    default nu = 0.05; M = the number of GP-screened candidates so far."""

    nu: float = 0.05

    def __call__(self, gp, X: torch.Tensor, aggregator=FirstElem,
                 iteration=0, M: int = 1) -> torch.Tensor:
        from limbo_tpu_torch.models.dispatch import query_any

        mu, var = query_any(gp, X)
        varsigma = math.sqrt(
            2.0 * math.log(math.pi ** 2 * max(M, 1) ** 2 / (12.0 * self.nu)))
        return aggregator(mu) + (varsigma + 0.2) * torch.sqrt(var)
