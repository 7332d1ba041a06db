"""Derivative-free inner optimizers: grid search, random point and random
sweep (port of limbo_tpu/opt/search.py).

Reference: src/limbo/opt/grid_search.hpp:71 (per-dimension grid, default 5
bins) and src/limbo/opt/random_point.hpp:59.  The candidate set is scored as
one (m, d) batch, the optimizers' batched protocol (opt/base.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from limbo_tpu_torch.opt.base import OptResult, take
from limbo_tpu_torch.utils.random import grid_points, random_vectors


def argmax_candidates(fun: Callable, X: torch.Tensor) -> OptResult:
    """Score a (m, d) candidate batch in one call; the first best wins."""
    with torch.no_grad():
        vals = fun(X)
    i = torch.argmax(vals)
    return OptResult(x=take(X, i), value=take(vals, i))


@dataclass
class GridSearch:
    """The full cartesian grid, (bins + 1)^d points, scored in one batch."""

    bins: int = 5

    def __call__(self, fun: Callable, init: torch.Tensor, generator=None,
                 bounded: bool = True) -> OptResult:
        X = grid_points(self.bins, init.shape[0], dtype=init.dtype,
                        device=init.device)
        return argmax_candidates(fun, X)


@dataclass
class RandomPoint:
    """One uniform random point in [0,1]^d (random_point.hpp:59)."""

    def __call__(self, fun: Callable, init: torch.Tensor, generator=None,
                 bounded: bool = True) -> OptResult:
        x = torch.rand(init.shape, generator=generator, dtype=init.dtype,
                       device=init.device)
        with torch.no_grad():
            return OptResult(x=x, value=fun(x[None, :])[0])


@dataclass
class RandomSweep:
    """The best of ``samples`` uniform random points, scored in one batch
    (the batched generalization of RandomPoint)."""

    samples: int = 1024

    def __call__(self, fun: Callable, init: torch.Tensor, generator=None,
                 bounded: bool = True) -> OptResult:
        X = random_vectors(generator, self.samples, init.shape[0],
                           dtype=init.dtype)
        return argmax_candidates(fun, X)
