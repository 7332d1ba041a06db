"""Bayesian-optimization loops (port of limbo_tpu/bo).

Only the hyperparameter-learning default of ``BOptimizerHPOpt`` is ported
so far; ``BOptimizer`` itself, the init designs, stopping criteria and stats
come with the small-n loop.
"""

from __future__ import annotations

from limbo_tpu_torch.models.hp_opt import KernelLFOpt
from limbo_tpu_torch.opt import ParallelRepeater, Rprop


def default_hp_opt(iterations: int = 100, repeats: int = 4) -> KernelLFOpt:
    """BOptimizerHPOpt's strategy (limbo BOptimizerHPOpt,
    bayes_opt/boptimizer.hpp:212; limbo_tpu/bo/__init__.py:38-39):
    KernelLFOpt over ParallelRepeater(Rprop(100), 4 repeats)."""
    return KernelLFOpt(optimizer=ParallelRepeater(
        sub=Rprop(iterations=iterations), repeats=repeats))


__all__ = ["default_hp_opt"]
