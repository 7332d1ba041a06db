"""Constrained inner optimization: an augmented-Lagrangian wrapper (port of
limbo_tpu/opt/constrained.py).

Reference capability: NLOpt's inequality / equality constraint interface
(src/limbo/opt/nlopt_base.hpp:116-130 ``add_inequality_constraint`` /
``add_equality_constraint``, exercised by src/tests/test_nlopt.cpp:100-165).
The augmented Lagrangian is the algorithm, and any of the port's inner
optimizers (Rprop, Adam, GradientAscent, Cmaes, RandomRestarts) is the
inner solver; constraint gradients come from autograd.

Convention (limbo's): MAXIMIZE f(x) subject to
    g_i(x) <= 0   (inequality),      h_j(x) = 0   (equality).

Method (Powell-Hestenes-Rockafellar updates):
    L(x) = f(x) - sum_j [lam_j h_j + (rho/2) h_j^2]
                - (1/2 rho) sum_i [max(0, mu_i + rho g_i)^2 - mu_i^2]
outer loop: maximize L with the sub-optimizer, then
    lam_j += rho h_j(x),  mu_i = max(0, mu_i + rho g_i(x)),  rho *= growth.

As every optimizer of the port (opt/base.py), ``fun`` and each constraint
map a (B, d) batch of points to their (B,) values.  A (R, d) batch of
starts carries its own multipliers, one row a start (the reference's
vmap); a (d,) start has one set, shared by every point the sub-optimizer
evaluates (a CMA-ES population).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Tuple

import torch

from limbo_tpu_torch.opt.base import OptResult
from limbo_tpu_torch.opt.gradient import Rprop
from limbo_tpu_torch.utils.random import split


def _default_sub():
    return Rprop(iterations=100)


def _at(c: Callable, x: torch.Tensor) -> torch.Tensor:
    """A batch function at a (d,) point or a (R, d) batch of points."""
    return c(x) if x.ndim == 2 else c(x[None, :])[0]


@dataclass
class AugmentedLagrangian:
    """Constraint-handling wrapper around any inner optimizer.

    ``inequality`` / ``equality`` are tuples of batch functions (B, d) ->
    (B,); ``add_*_constraint`` returns a new object, as the reference's.
    """

    sub: object = field(default_factory=_default_sub)
    inequality: Tuple[Callable, ...] = ()
    equality: Tuple[Callable, ...] = ()
    outer_iterations: int = 10
    rho0: float = 1.0
    rho_growth: float = 2.0

    # composition helpers (nlopt_base.hpp add_*_constraint)
    def add_inequality_constraint(self, g: Callable) -> "AugmentedLagrangian":
        return dataclasses.replace(self, inequality=self.inequality + (g,))

    def add_equality_constraint(self, h: Callable) -> "AugmentedLagrangian":
        return dataclasses.replace(self, equality=self.equality + (h,))

    def __call__(self, fun: Callable, init: torch.Tensor,
                 generator: torch.Generator = None,
                 bounded: bool = False) -> OptResult:
        """Maximize ``fun`` under the constraints from ``init``; the
        sub-optimizer's generator of each outer round is split from
        ``generator`` (default: seeded with 0, the reference's default
        key), where the reference splits its key."""
        if generator is None:
            generator = torch.Generator(device=init.device).manual_seed(0)
        kw = dict(dtype=init.dtype, device=init.device)
        lead = init.shape[:-1]               # () or (R,)
        lam = torch.zeros(lead + (max(len(self.equality), 1),), **kw)
        mu = torch.zeros(lead + (max(len(self.inequality), 1),), **kw)
        rho = torch.tensor(self.rho0, **kw)
        x = init

        def augmented(X, lam, mu, rho):
            v = fun(X)
            for j, h in enumerate(self.equality):
                hv = h(X)
                v = v - (lam[..., j] * hv + 0.5 * rho * hv * hv)
            for i, g in enumerate(self.inequality):
                gv = g(X)
                t = torch.clamp(mu[..., i] + rho * gv, min=0.0)
                v = v - (t * t - mu[..., i] * mu[..., i]) / (2.0 * rho)
            return v

        for _ in range(self.outer_iterations):
            sub_gen = split(generator)
            lam_c, mu_c, rho_c = lam, mu, rho     # this round's multipliers
            res = self.sub(lambda X: augmented(X, lam_c, mu_c, rho_c), x,
                           sub_gen, bounded)
            x = res.x.detach()
            with torch.no_grad():
                lam = lam.clone()
                mu = mu.clone()
                for j, h in enumerate(self.equality):
                    lam[..., j] += rho * _at(h, x)
                for i, g in enumerate(self.inequality):
                    mu[..., i] = torch.clamp(mu[..., i] + rho * _at(g, x),
                                             min=0.0)
            rho = rho * self.rho_growth
        with torch.no_grad():
            return OptResult(x=x, value=_at(fun, x))
