"""Stop criteria for the BO loop (port of limbo_tpu/bo/stop.py).

Reference: src/limbo/stop/{max_iterations,max_predicted_value,
chain_criteria}.hpp.  A criterion is a callable ``(state) -> bool``
evaluated on the host between iterations; the driver OR-folds a tuple of
them (limbo chains via boost::fusion::accumulate, chain_criteria.hpp:65).
A criterion with ``device_stop`` also runs inside ``optimize_jit``, where
its decision stays on the device as a 0-d bool tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from limbo_tpu_torch.models.dispatch import query_any
from limbo_tpu_torch.opt.compose import RandomRestarts
from limbo_tpu_torch.opt.gradient import Rprop


@dataclass
class MaxIterations:
    """Stop after ``iterations`` BO iterations of the current run (default
    190, stop/max_iterations.hpp:55-64)."""

    iterations: int = 190

    def __call__(self, state) -> bool:
        return state.iteration >= self.iterations


@dataclass
class MaxPredictedValue:
    """Stop when the best observation >= ratio * the model's largest
    predicted value (stop/max_predicted_value.hpp:71; default ratio 0.9).

    The model maximum is searched by ``optimizer`` on the posterior mean
    (limbo optimizes afun(mu(x)) with its acquisition optimizer).
    """

    ratio: float = 0.9
    optimizer: object = field(
        default_factory=lambda: RandomRestarts(sub=Rprop(iterations=50),
                                               repeats=8, sweep_samples=512))

    def device_stop(self, gp, best_value, generator,
                    aggregator) -> torch.Tensor:
        """The decision for a model, a best value (a number or a tensor on
        the model's device) and the generator of the optimizer's draws, as
        a 0-d bool tensor on the device: nothing here waits on the card, so
        optimize_jit's captured stop check can hold it (the reference's
        jit-safe check, limbo_tpu/bo/stop.py:46)."""
        def mean_val(X):
            mu, _ = query_any(gp, X)
            return aggregator(mu)

        start = torch.full((gp.dim_in,), 0.5, dtype=gp.x.dtype,
                           device=gp.x.device)
        res = self.optimizer(mean_val, start, generator, True)
        best = torch.as_tensor(best_value, dtype=gp.x.dtype,
                               device=gp.x.device)
        return best >= self.ratio * res.value

    def __call__(self, state) -> bool:
        return bool(self.device_stop(state.gp, state.best_value,
                                     state.generator, state.aggregator))
