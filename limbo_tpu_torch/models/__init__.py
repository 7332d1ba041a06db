from limbo_tpu_torch.models import iterative, multi_gp, sparse_gp, spgp
from limbo_tpu_torch.models.dispatch import add_sample_any, query_any
from limbo_tpu_torch.models.gp import (GP, CachedGPView, QueryCache,
                                       add_sample, add_sample_cached, empty,
                                       fit, grow, inv_kernel, log_lik,
                                       log_loo_cv, log_loo_cv_fn,
                                       log_marginal_likelihood,
                                       mean_observation, observations, query,
                                       query_cached, recompute, samples)
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
           "SPGPHpOpt"]
