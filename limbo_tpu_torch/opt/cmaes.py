"""Batched CMA-ES (port of limbo_tpu/opt/cmaes.py).

Reference capability: src/limbo/opt/cmaes.hpp:168 wraps libcmaes (aIPOP,
multithreaded population evaluation, the pwq bound transform).  As the
reference, this is a from-scratch (mu/mu_w, lambda)-CMA-ES with Hansen's
standard updates (CSA step size, rank-one + rank-mu covariance
adaptation):

* the population of every restart is one (restarts * lambda, d) batch, one
  call of the objective per generation (the optimizers' batched protocol,
  opt/base.py); restarts are a batch axis, the reference's vmap;
* bounds: the reflection genotype -> phenotype map ``reflect01``;
* every draw, z of shape (restarts, iterations, lambda, d), is taken from
  the generator up front (``__call__``), and ``from_draws`` / ``generation``
  are plain functions of the state and the draws, so a test hands in the
  reference's;
* the covariance's eigendecomposition is ``ops/sym_eig.py`` (a kernel on
  the card, with no host read-back, so a generation runs inside a captured
  BO iteration).  Its eigenvalues ascend as LAPACK's; an eigenvector's sign
  may differ from another solver's, which flips the matching column of z.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from limbo_tpu_torch.opt.base import OptResult, take
from limbo_tpu_torch.ops.sym_eig import sym_eig


def reflect01(x: torch.Tensor) -> torch.Tensor:
    """Reflect R^d onto [0,1]^d (triangle wave): preserves CMA dynamics while
    keeping evaluated phenotypes feasible."""
    return 1.0 - torch.abs(torch.remainder(x, 2.0) - 1.0)


@dataclass
class CmaesState:
    """One generation's carry for every restart: mean m (R, d), step size
    sigma (R,), covariance C (R, d, d), evolution paths ps, pc (R, d), the
    best phenotype and value so far (R, d), (R,), and the generation t."""

    m: torch.Tensor
    sigma: torch.Tensor
    C: torch.Tensor
    ps: torch.Tensor
    pc: torch.Tensor
    best_x: torch.Tensor
    best_v: torch.Tensor
    t: int = 0


@dataclass
class Cmaes:
    iterations: int = 120
    pop_size: int = 0        # 0 -> Hansen's default 4 + floor(3 ln d)
    sigma0: float = 0.3
    restarts: int = 1
    # the reference shards the population over a device mesh; the port's
    # multi-GPU layer is not written yet
    mesh: object = None
    mesh_axis: str = None

    def __post_init__(self):
        if self.mesh is not None or self.mesh_axis is not None:
            raise NotImplementedError(
                "Cmaes(mesh=...) is not ported to limbo_tpu_torch yet "
                "(ROADMAP.md queue 1, item 7)")

    def pop(self, d: int) -> int:
        """lambda (at least 4)."""
        lam = (self.pop_size if self.pop_size > 0
               else 4 + int(3 * math.log(d)) if d > 1 else 4)
        return max(lam, 4)

    def __call__(self, fun: Callable, init: torch.Tensor,
                 generator: torch.Generator, bounded: bool = True
                 ) -> OptResult:
        d = init.shape[0]
        z = torch.randn((max(self.restarts, 1), self.iterations,
                         self.pop(d), d), generator=generator,
                        dtype=init.dtype, device=init.device)
        return self.from_draws(fun, init, z, bounded)

    def from_draws(self, fun: Callable, init: torch.Tensor, z: torch.Tensor,
                   bounded: bool = True) -> OptResult:
        """The deterministic rest of __call__, given the draws z
        (restarts, iterations, lambda, d): every generation, then the best
        restart (the first best, as jnp.argmax picks)."""
        state = self.init_state(init, z.shape[0], bounded)
        for t in range(z.shape[1]):
            state = self.generation(fun, state, z[:, t], bounded)
        if z.shape[0] == 1:
            return OptResult(x=state.best_x[0], value=state.best_v[0])
        i = torch.argmax(state.best_v)
        return OptResult(x=take(state.best_x, i), value=take(state.best_v, i))

    def init_state(self, init: torch.Tensor, restarts: int,
                   bounded: bool = True) -> CmaesState:
        d, kw = init.shape[0], dict(dtype=init.dtype, device=init.device)
        m0 = torch.clamp(init, 0.0, 1.0) if bounded else init
        m0 = m0[None, :].expand(restarts, d).clone()
        return CmaesState(
            m=m0, sigma=torch.full((restarts,), self.sigma0, **kw),
            C=torch.eye(d, **kw).expand(restarts, d, d).clone(),
            ps=torch.zeros((restarts, d), **kw),
            pc=torch.zeros((restarts, d), **kw), best_x=m0.clone(),
            best_v=torch.full((restarts,), -torch.inf, **kw))

    def constants(self, d: int, lam: int):
        """(mu, mueff, cs, ds, cc, c1, cmu, chiN): Hansen's 2016 tutorial
        defaults, as the reference (mueff from the recombination weights
        in f64 on the host)."""
        mu = lam // 2
        w = math.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        w = w / w.sum()
        mueff = float(1.0 / np.sum(w ** 2))
        cs = (mueff + 2.0) / (d + mueff + 5.0)
        ds = (1.0 + 2.0 * max(0.0, math.sqrt((mueff - 1.0) / (d + 1.0))
                              - 1.0) + cs)
        cc = (4.0 + mueff / d) / (d + 4.0 + 2.0 * mueff / d)
        c1 = 2.0 / ((d + 1.3) ** 2 + mueff)
        cmu = min(1.0 - c1, 2.0 * (mueff - 2.0 + 1.0 / mueff)
                  / ((d + 2.0) ** 2 + mueff))
        chiN = math.sqrt(d) * (1.0 - 1.0 / (4.0 * d) + 1.0 / (21.0 * d * d))
        return mu, mueff, cs, ds, cc, c1, cmu, chiN

    def generation(self, fun: Callable, s: CmaesState, z: torch.Tensor,
                   bounded: bool = True) -> CmaesState:
        """One generation of every restart from its draws z (R, lambda, d):
        sample, evaluate (one batch), rank, recombine, adapt."""
        R, lam, d = z.shape
        mu, mueff, cs, ds, cc, c1, cmu, chiN = self.constants(d, lam)
        # the weights on the device (a copy from the host cannot be
        # captured)
        w = math.log(mu + 0.5) - torch.log(torch.arange(
            1, mu + 1, dtype=torch.float64, device=z.device))
        w = (w / w.sum()).to(z.dtype)
        pheno = reflect01 if bounded else (lambda x: x)
        # sample: y = B D z, x = m + sigma y
        evals, B = sym_eig(s.C)
        D = torch.sqrt(torch.clamp(evals, min=1e-20))
        y = (z * D[:, None, :]) @ B.transpose(-1, -2)            # (R, lam, d)
        xs = s.m[:, None, :] + s.sigma[:, None, None] * y
        with torch.no_grad():
            fs = fun(pheno(xs).reshape(R * lam, d)).reshape(R, lam)
        order = torch.argsort(-fs, dim=1, stable=True)
        y_sorted = torch.gather(y, 1, order[:, :mu, None].expand(R, mu, d))
        # the best phenotype so far
        g = order[:, :1]
        f_g = torch.gather(fs, 1, g)[:, 0]
        x_g = torch.gather(xs, 1, g[:, :, None].expand(R, 1, d))[:, 0]
        better = f_g > s.best_v
        best_x = torch.where(better[:, None], pheno(x_g), s.best_x)
        best_v = torch.where(better, f_g, s.best_v)
        # recombination
        y_w = torch.einsum("i,rij->rj", w, y_sorted)
        m = s.m + s.sigma[:, None] * y_w
        # step-size control (CSA)
        Bt_yw = torch.einsum("rji,rj->ri", B, y_w)
        Cinvsqrt_yw = torch.einsum("rij,rj->ri", B * (1.0 / D)[:, None, :],
                                   Bt_yw)
        ps = ((1 - cs) * s.ps
              + math.sqrt(cs * (2 - cs) * mueff) * Cinvsqrt_yw)
        ps_norm = torch.linalg.norm(ps, dim=-1)
        sigma = s.sigma * torch.exp((cs / ds) * (ps_norm / chiN - 1.0))
        # covariance adaptation
        hsig = (ps_norm / math.sqrt(1 - (1 - cs) ** (2 * (s.t + 1)))
                < (1.4 + 2.0 / (d + 1)) * chiN).to(z.dtype)
        pc = ((1 - cc) * s.pc
              + hsig[:, None] * math.sqrt(cc * (2 - cc) * mueff) * y_w)
        rank1 = pc[:, :, None] * pc[:, None, :]
        rankmu = torch.einsum("i,rij,rik->rjk", w, y_sorted, y_sorted)
        delta_hsig = (1 - hsig) * cc * (2 - cc)
        C = ((1 - c1 - cmu) * s.C
             + c1 * (rank1 + delta_hsig[:, None, None] * s.C)
             + cmu * rankmu)
        C = 0.5 * (C + C.transpose(-1, -2))
        sigma = torch.clamp(sigma, 1e-12, 1e6)
        return CmaesState(m=m, sigma=sigma, C=C, ps=ps, pc=pc, best_x=best_x,
                          best_v=best_v, t=s.t + 1)
