from limbo_tpu_torch.models.gp import (GP, CachedGPView, QueryCache,
                                       add_sample, add_sample_cached, empty,
                                       fit, grow, inv_kernel, log_lik,
                                       log_loo_cv, log_loo_cv_fn,
                                       log_marginal_likelihood,
                                       mean_observation, observations, query,
                                       query_cached, recompute, samples)

__all__ = ["GP", "CachedGPView", "QueryCache", "add_sample",
           "add_sample_cached", "empty", "fit", "grow", "inv_kernel",
           "log_lik", "log_loo_cv", "log_loo_cv_fn",
           "log_marginal_likelihood", "mean_observation", "observations",
           "query", "query_cached", "recompute", "samples"]
