from limbo_tpu_torch.models.gp import (GP, CachedGPView, QueryCache,
                                       add_sample, add_sample_cached, empty,
                                       fit, grow, query, query_cached,
                                       recompute)

__all__ = ["GP", "CachedGPView", "QueryCache", "add_sample",
           "add_sample_cached", "empty", "fit", "grow", "query",
           "query_cached", "recompute"]
