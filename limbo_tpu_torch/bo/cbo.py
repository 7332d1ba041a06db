"""Constrained Bayesian optimization: CBOptimizer and the ECI acquisition
(port of limbo_tpu/bo/cbo.py).

Reference: src/limbo/experimental/bayes_opt/cboptimizer.hpp:120 (an
objective GP and a constraint GP over the split observation vector) and
experimental/acqui/eci.hpp:66 (Expected Constrained Improvement = EI(x)
times the probability of feasibility, where a constraint observation of 1
means feasible and Pf = Phi((mu_c - 1) / sigma_c), eci.hpp:115-130).

The objective returns the concatenated vector [objectives (dim_out),
constraints (nb_constraints)]; constraint values lie in [0, 1] with 1 =
satisfied (limbo's cbo example, src/examples/experimental/cbo.cpp).  As the
reference, the loop refits both GPs from scratch every iteration, in
buffers of one capacity for the whole run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from limbo_tpu_torch.acqui.acqui import EI, FirstElem
from limbo_tpu_torch.bo.init_designs import RandomSampling
from limbo_tpu_torch.bo.optimizer import (EvaluationError,
                                          default_acqui_optimizer)
from limbo_tpu_torch.bo.stop import MaxIterations
from limbo_tpu_torch.kernels import Exp, MaternFiveHalves
from limbo_tpu_torch.means import ConstantMean, DataMean
from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.models.dispatch import query_any
from limbo_tpu_torch.utils.device import resolve_device


@dataclass
class ECI:
    """Expected constrained improvement (eci.hpp:66): EI * Pf over a
    (q, d) batch, Pf = 1 where sigma_c < 1e-10 or the constraint GP has no
    sample (limbo_tpu/bo/cbo.py:48-53)."""

    jitter: float = 0.0

    def __call__(self, model, constraint_model, X: torch.Tensor,
                 aggregator=FirstElem, iteration=0, f_max=None
                 ) -> torch.Tensor:
        val = EI(jitter=self.jitter)(model, X, aggregator, iteration,
                                     f_max=f_max)
        return val * self.feasibility(constraint_model, X, aggregator)

    @staticmethod
    def feasibility(constraint_model, X: torch.Tensor,
                    aggregator=FirstElem) -> torch.Tensor:
        """Pf at each row of X (eci.hpp:115-130)."""
        mu_c, var_c = query_any(constraint_model, X)
        sigma_c = torch.sqrt(var_c)
        Z = (aggregator(mu_c) - 1.0) / torch.clamp(sigma_c, min=1e-10)
        Pf = 0.5 * torch.erfc(-Z / math.sqrt(2.0))
        one = (sigma_c < 1e-10) | (constraint_model.n_dev < 1)
        return torch.where(one, torch.ones_like(Pf), Pf)


class CBOptimizer:
    """The constrained BO loop (cboptimizer.hpp optimize:148-195).

    Defaults as the reference's: a Matérn-5/2 + DataMean objective model,
    an Exp + ConstantMean(1) constraint model, ECI, the default
    acquisition optimizer started from 0.5, RandomSampling(10),
    MaxIterations(30) and f64."""

    def __init__(self, nb_constraints: int, dim_out: int = 1,
                 kernel=None, constraint_kernel=None,
                 mean=None, constraint_mean=None,
                 acqui: Optional[ECI] = None, acqui_optimizer=None,
                 init=None, stop: Sequence = None,
                 hp_opt=None, hp_period: int = -1,
                 dtype=torch.float64, device="cuda"):
        self.device = resolve_device(device)
        self.nb_constraints = nb_constraints
        self.dim_out = dim_out
        self.kernel = kernel
        self.constraint_kernel = constraint_kernel
        self.mean = mean
        self.constraint_mean = constraint_mean
        self.acqui = acqui if acqui is not None else ECI()
        self.acqui_optimizer = (acqui_optimizer if acqui_optimizer is not None
                                else default_acqui_optimizer())
        self.init = init if init is not None else RandomSampling(10)
        self.stop = tuple(stop) if stop is not None else (MaxIterations(30),)
        self.hp_opt = hp_opt
        self.hp_period = hp_period
        self.dtype = dtype
        self.X: list = []
        self.Yobj: list = []
        self.Ycon: list = []
        self.iteration = 0

    def _max_iters(self) -> int:
        for s in self.stop:
            if isinstance(s, MaxIterations):
                return s.iterations
        return 30

    def _eval_split(self, f, x):
        y = np.atleast_1d(np.asarray(f(x), dtype=np.float64))
        if not np.all(np.isfinite(y)):
            raise EvaluationError(f"invalid observation {y} at {x}")
        return y[: self.dim_out], y[self.dim_out:]

    def _models(self):
        """The default models' modules (cboptimizer.hpp's defaults)."""
        kw = dict(device=self.device, dtype=self.dtype)
        kern = (self.kernel if self.kernel is not None
                else MaternFiveHalves.create(**kw))
        ckern = (self.constraint_kernel if self.constraint_kernel is not None
                 else Exp.create(**kw))
        mean = (self.mean if self.mean is not None
                else DataMean.create(dim_out=self.dim_out, **kw))
        cmean = (self.constraint_mean if self.constraint_mean is not None
                 else ConstantMean.create(1.0, dim_out=self.nb_constraints,
                                          **kw))
        return kern, ckern, mean, cmean

    def fit(self, capacity: int):
        """(objective GP, constraint GP) fitted from scratch to the samples
        so far."""
        kern, ckern, mean, cmean = self._models()
        kw = dict(capacity=capacity, device=self.device, dtype=self.dtype)
        X = torch.tensor(np.stack(self.X), dtype=self.dtype,
                         device=self.device)
        model = gp_mod.fit(kern, mean, X, np.stack(self.Yobj), **kw)
        cmodel = gp_mod.fit(ckern, cmean, X, np.stack(self.Ycon), **kw)
        return model, cmodel

    def propose(self, model, cmodel, generator: torch.Generator,
                iteration: int):
        """The acquisition optimizer's result over ECI, from 0.5
        (limbo_tpu/bo/cbo.py:102-114), on the device."""
        with torch.no_grad():
            f_max = EI().best_predicted(model, FirstElem)

        def acq(X):
            return self.acqui(model, cmodel, X, FirstElem, iteration,
                              f_max=f_max)

        start = torch.full((model.dim_in,), 0.5, dtype=self.dtype,
                           device=self.device)
        return self.acqui_optimizer(acq, start, generator, True)

    def optimize(self, f: Callable, dim: int,
                 generator: Optional[torch.Generator] = None,
                 reset: bool = True) -> "CBOptimizer":
        """Run the loop: f maps a (d,) numpy array to the (dim_out +
        nb_constraints,) observation.  generator: every draw's
        torch.Generator on this optimizer's device (default: seeded with
        0)."""
        gen = (generator if generator is not None
               else torch.Generator(device=self.device).manual_seed(0))
        if reset:
            self.X, self.Yobj, self.Ycon = [], [], []
            self.iteration = 0
            X0 = self.init(gen, dim, dtype=self.dtype).cpu().numpy()
            for x in X0:
                yo, yc = self._eval_split(f, x)
                self.X.append(x)
                self.Yobj.append(yo)
                self.Ycon.append(yc)
        cap = max(64, -(-(len(self.X) + self._max_iters() + 1) // 64) * 64)
        while self.iteration < self._max_iters():
            model, cmodel = self.fit(cap)
            if (self.hp_opt is not None and self.hp_period > 0
                    and (self.iteration + 1) % self.hp_period == 0):
                model = self.hp_opt(model, gen)
            res = self.propose(model, cmodel, gen, self.iteration)
            x_new = res.x.detach().cpu().numpy()
            yo, yc = self._eval_split(f, x_new)
            self.X.append(x_new)
            self.Yobj.append(yo)
            self.Ycon.append(yc)
            self.iteration += 1
        return self

    # -- feasibility-aware bests (cboptimizer.hpp:198-232) -------------------

    def _feasible_mask(self) -> np.ndarray:
        if self.nb_constraints == 0:
            return np.ones(len(self.X), dtype=bool)
        C = np.stack(self.Ycon)
        return np.all(C >= 1.0 - 1e-9, axis=1)

    @property
    def best_observation(self) -> np.ndarray:
        Y = np.stack(self.Yobj)
        feas = self._feasible_mask()
        pool = Y[feas] if feas.any() else Y
        return pool[np.argmax(pool[:, 0])]

    @property
    def best_sample(self) -> np.ndarray:
        Y = np.stack(self.Yobj)[:, 0]
        X = np.stack(self.X)
        feas = self._feasible_mask()
        if feas.any():
            idx = np.flatnonzero(feas)
            return X[idx[np.argmax(Y[feas])]]
        return X[np.argmax(Y)]
