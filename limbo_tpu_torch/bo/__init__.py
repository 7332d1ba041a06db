"""Bayesian-optimization loops (port of limbo_tpu/bo): the single-objective
``BOptimizer`` with its init designs, stop criteria and stats writers, and
``BOptimizerHPOpt``."""

from __future__ import annotations

import torch

from limbo_tpu_torch.bo import stats
from limbo_tpu_torch.bo.init_designs import (LHS, GridSampling, NoInit,
                                             RandomSampling,
                                             RandomSamplingGrid)
from limbo_tpu_torch.bo.optimizer import (BOptimizer, BOState,
                                          EvaluationError,
                                          default_acqui_optimizer)
from limbo_tpu_torch.bo.stop import MaxIterations, MaxPredictedValue
from limbo_tpu_torch.models.hp_opt import KernelLFOpt
from limbo_tpu_torch.opt import ParallelRepeater, Rprop

__all__ = [
    "BOptimizer", "BOState", "EvaluationError", "default_acqui_optimizer",
    "RandomSampling", "RandomSamplingGrid", "GridSampling", "LHS", "NoInit",
    "MaxIterations", "MaxPredictedValue", "stats", "BOptimizerHPOpt",
    "default_hp_opt",
]


def default_hp_opt(iterations: int = 100, repeats: int = 4) -> KernelLFOpt:
    """BOptimizerHPOpt's strategy (limbo BOptimizerHPOpt,
    bayes_opt/boptimizer.hpp:212; limbo_tpu/bo/__init__.py:38-39):
    KernelLFOpt over ParallelRepeater(Rprop(100), 4 repeats)."""
    return KernelLFOpt(optimizer=ParallelRepeater(
        sub=Rprop(iterations=iterations), repeats=repeats))


def BOptimizerHPOpt(**kwargs) -> BOptimizer:
    """BOptimizer preconfigured for hyperparameter learning (limbo
    BOptimizerHPOpt, bayes_opt/boptimizer.hpp:212): a SquaredExpARD kernel
    when ``dim_in`` is given, and ``default_hp_opt()`` every ``hp_period``
    (default 10) iterations."""
    from limbo_tpu_torch.kernels import SquaredExpARD

    dim_in = kwargs.pop("dim_in", None)
    kwargs.setdefault("hp_opt", default_hp_opt())
    kwargs.setdefault("hp_period", 10)
    if dim_in is not None and "kernel" not in kwargs:
        kwargs["kernel"] = SquaredExpARD.create(
            dim=dim_in, device=kwargs.get("device", "cuda"),
            dtype=kwargs.get("dtype", torch.float32))
    return BOptimizer(**kwargs)
