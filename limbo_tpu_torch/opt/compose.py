"""Optimizer combinators: perturbed repeats, batched random restarts and
sequential chaining (port of limbo_tpu/opt/compose.py).

RandomRestarts hands its restarts to the sub-optimizer as one (repeats, d)
tensor, the counterpart of the reference's vmap.  ParallelRepeater runs its
repeats one after another: its user is hyperparameter learning, where each
repeat holds O(N^2) buffers at large n.  Every draw (perturbations, sweep
points, random starts) is split from a deterministic ``from_inits`` /
``from_sweep`` so that a test can feed the reference's own draws.  Chained
(src/limbo/opt/chained.hpp:60) runs optimizers in sequence, each from the
previous result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from limbo_tpu_torch.opt.base import OptResult, take
from limbo_tpu_torch.utils.random import halton


@dataclass
class ParallelRepeater:
    """``repeats`` runs of the sub-optimizer from init + U(-epsilon,
    epsilon) perturbations; the best is kept (limbo opt::ParallelRepeater,
    parallel_repeater.hpp:77).  limbo spreads the repeats over threads and
    the reference over a vmap axis; here they run in sequence, so only one
    repeat's buffers are alive at a time."""

    sub: object
    repeats: int = 10
    epsilon: float = 1e-2

    def __call__(self, fun: Callable, init: torch.Tensor,
                 generator: torch.Generator, bounded: bool = False
                 ) -> OptResult:
        u = torch.rand((self.repeats, init.shape[0]), generator=generator,
                       dtype=init.dtype, device=init.device)
        pert = (2.0 * u - 1.0) * self.epsilon
        return self.from_inits(fun, init[None, :] + pert, bounded,
                               generator=generator)

    def from_inits(self, fun: Callable, inits: torch.Tensor,
                   bounded: bool = False, generator=None) -> OptResult:
        """The deterministic rest of __call__, given the (repeats, d)
        perturbed starts: the first best value wins, as jnp.argmax picks."""
        res = [self.sub(fun, x0, generator, bounded) for x0 in inits]
        value = torch.stack([r.value for r in res])
        i = torch.argmax(value)
        return OptResult(x=take(torch.stack([r.x for r in res]), i),
                         value=take(value, i))


@dataclass
class RandomRestarts:
    """Global sweep + multi-start ascent, the acquisition-optimizer default.

    With ``seed_from_sweep`` (default), a dense sweep runs FIRST and, when
    it has at least ``repeats`` points, its best candidates seed the
    ascents; otherwise the starts are uniform random and the sweep only
    competes at the end.  ``sweep_kind`` is "uniform" or "halton" (a
    randomized Halton set, utils/random.halton).  With ``polish_k`` and
    ``polish_steps``, the ``polish_k`` best carries of the ascent continue
    for ``polish_steps`` more steps through the sub-optimizer's resumable
    ``run(..., state=, iterations=)`` (Rprop's).
    """

    sub: object
    repeats: int = 16
    sweep_samples: int = 0
    seed_from_sweep: bool = True
    polish_k: int = 0
    polish_steps: int = 0
    sweep_kind: str = "uniform"

    def __call__(self, fun: Callable, init: torch.Tensor,
                 generator: torch.Generator, bounded: bool = True
                 ) -> OptResult:
        d = init.shape[0]
        kw = dict(generator=generator, dtype=init.dtype, device=init.device)
        sweep_x = None
        if self.sweep_samples > 0:
            sweep_x = (halton(generator, self.sweep_samples, d,
                              dtype=init.dtype)
                       if self.sweep_kind == "halton"
                       else torch.rand((self.sweep_samples, d), **kw))
        starts = None
        if not self._seeded():
            starts = torch.rand((self.repeats, d), **kw)
        return self.from_sweep(fun, init, sweep_x, bounded, starts=starts,
                               generator=generator)

    def _seeded(self) -> bool:
        return self.seed_from_sweep and self.sweep_samples >= self.repeats

    def from_sweep(self, fun: Callable, init: torch.Tensor, sweep_x,
                   bounded: bool = True, starts=None, generator=None
                   ) -> OptResult:
        """The deterministic rest of __call__, given the sweep points
        (sweep_samples, d) and, when the starts are not seeded from the
        sweep, the random starts (repeats, d)."""
        if sweep_x is not None:
            with torch.no_grad():
                sweep_v = fun(sweep_x)
        if self._seeded():
            top = torch.topk(sweep_v, self.repeats).indices
            inits = sweep_x[top]
        else:
            inits = starts.clone()
        inits[0] = init
        if self.polish_k > 0 and self.polish_steps > 0:
            if not hasattr(self.sub, "run"):
                raise ValueError(
                    "polish_k/polish_steps require a resumable sub-optimizer "
                    "exposing run(..., state=, iterations=); "
                    f"{type(self.sub).__name__} has no run()")
            res, state = self.sub.run(fun, inits, generator, bounded)
            top = torch.topk(res.value, min(self.polish_k,
                                            self.repeats)).indices
            res, _ = self.sub.run(fun, None, None, bounded,
                                  state=tuple(a[top] for a in state),
                                  iterations=self.polish_steps)
        else:
            res = self.sub(fun, inits, generator, bounded)
        i = torch.argmax(res.value)
        best_x, best_v = take(res.x, i), take(res.value, i)
        if sweep_x is not None:
            j = torch.argmax(sweep_v)
            better = take(sweep_v, j) > best_v
            best_x = torch.where(better, take(sweep_x, j), best_x)
            best_v = torch.where(better, take(sweep_v, j), best_v)
        return OptResult(x=best_x, value=best_v)


@dataclass
class Chained:
    """Optimizers in sequence, each from the previous one's result; the
    best result of any wins (limbo opt::Chained, chained.hpp:60)."""

    subs: Tuple = ()

    def __call__(self, fun: Callable, init: torch.Tensor,
                 generator: torch.Generator = None, bounded: bool = False
                 ) -> OptResult:
        x = init
        best = OptResult(x=init, value=torch.tensor(
            -torch.inf, dtype=init.dtype, device=init.device))
        for sub in self.subs:
            res = sub(fun, x, generator, bounded)
            x = res.x
            better = res.value > best.value
            best = OptResult(x=torch.where(better, res.x, best.x),
                             value=torch.where(better, res.value, best.value))
        return best
