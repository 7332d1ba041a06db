"""Optimizer combinators: batched random restarts (port of the
RandomRestarts of limbo_tpu/opt/compose.py).

The restarts are one (repeats, d) tensor handed to the sub-optimizer, the
counterpart of the reference's vmap.  The draws (sweep points and, without
sweep seeding, the random starts) are split from the deterministic
``from_sweep`` so that a test can feed the reference's own draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from limbo_tpu_torch.opt.base import OptResult


@dataclass
class RandomRestarts:
    """Global sweep + multi-start ascent, the acquisition-optimizer default.

    A dense uniform sweep runs FIRST and, when it has at least ``repeats``
    points, its best candidates seed the ascents; otherwise the starts are
    uniform random and the sweep only competes at the end.
    """

    sub: object
    repeats: int = 16
    sweep_samples: int = 0

    def __call__(self, fun: Callable, init: torch.Tensor,
                 generator: torch.Generator, bounded: bool = True
                 ) -> OptResult:
        d = init.shape[0]
        kw = dict(generator=generator, dtype=init.dtype, device=init.device)
        sweep_x = (torch.rand((self.sweep_samples, d), **kw)
                   if self.sweep_samples > 0 else None)
        starts = None
        if not self._seeded():
            starts = torch.rand((self.repeats, d), **kw)
        return self.from_sweep(fun, init, sweep_x, bounded, starts=starts,
                               generator=generator)

    def _seeded(self) -> bool:
        return self.sweep_samples >= self.repeats

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
        res = self.sub(fun, inits, generator, bounded)
        i = torch.argmax(res.value)
        best_x, best_v = res.x[i], res.value[i]
        if sweep_x is not None:
            j = torch.argmax(sweep_v)
            better = sweep_v[j] > best_v
            best_x = torch.where(better, sweep_x[j], best_x)
            best_v = torch.where(better, sweep_v[j], best_v)
        return OptResult(x=best_x, value=best_v)
