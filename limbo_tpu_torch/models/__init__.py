import torch

from limbo_tpu_torch.models import iterative, multi_gp, sparse_gp, spgp
from limbo_tpu_torch.models.dispatch import add_sample_any, query_any
from limbo_tpu_torch.models.gp import (GP, CachedGPView, QueryCache,
                                       add_sample, add_sample_cached, empty,
                                       fit, grow, inv_kernel, log_lik,
                                       log_loo_cv, log_loo_cv_fn,
                                       log_marginal_likelihood,
                                       mean_observation, observations, query,
                                       query_cached, recompute, samples)
from limbo_tpu_torch.models.hp_opt import (KernelLFOpt, KernelLooOpt,
                                           KernelMeanLFOpt, MeanLFOpt,
                                           NoLFOpt)
from limbo_tpu_torch.models.iterative import IterativeGP
from limbo_tpu_torch.models.multi_gp import MultiGP, ParallelLFOpt
from limbo_tpu_torch.models.sparse_gp import SparsifiedGP
from limbo_tpu_torch.models.spgp import SPGP, SPGPHpOpt

__all__ = ["GP", "CachedGPView", "QueryCache", "add_sample",
           "add_sample_cached", "empty", "fit", "grow", "inv_kernel",
           "log_lik", "log_loo_cv", "log_loo_cv_fn",
           "log_marginal_likelihood", "mean_observation", "observations",
           "query", "query_cached", "recompute", "samples", "query_any",
           "add_sample_any", "iterative", "multi_gp", "sparse_gp", "spgp",
           "IterativeGP", "MultiGP", "ParallelLFOpt", "SparsifiedGP", "SPGP",
           "SPGPHpOpt", "KernelLFOpt", "KernelLooOpt", "KernelMeanLFOpt",
           "MeanLFOpt", "NoLFOpt", "GPBasic", "GPOpt"]


def GPBasic(dim_in: int, dim_out: int = 1, capacity: int = 256, dtype=None,
            device="cuda"):
    """Matern-5/2 + DataMean, no hp-opt (limbo model::GPBasic,
    model/gp.hpp:637): an empty GP (limbo_tpu/models/__init__.py:27)."""
    from limbo_tpu_torch.kernels import MaternFiveHalves
    from limbo_tpu_torch.means import DataMean

    kw = dict(dtype=dtype if dtype is not None else torch.float32,
              device=device)
    return empty(MaternFiveHalves.create(**kw),
                 DataMean.create(dim_out=dim_out, **kw),
                 dim_in, dim_out, capacity, **kw)


def GPOpt(dim_in: int, dim_out: int = 1, capacity: int = 256, dtype=None,
          device="cuda"):
    """SquaredExpARD + DataMean, to be trained with KernelLFOpt (limbo
    model::GPOpt, model/gp.hpp:642): an empty GP
    (limbo_tpu/models/__init__.py:42)."""
    from limbo_tpu_torch.kernels import SquaredExpARD
    from limbo_tpu_torch.means import DataMean

    kw = dict(dtype=dtype if dtype is not None else torch.float32,
              device=device)
    return empty(SquaredExpARD.create(dim=dim_in, **kw),
                 DataMean.create(dim_out=dim_out, **kw),
                 dim_in, dim_out, capacity, **kw)
