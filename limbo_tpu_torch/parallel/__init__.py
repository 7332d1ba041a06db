"""The distribution layer on torch.distributed (port of limbo_tpu/parallel):
process groups and meshes, the counted collectives, restart fan-out and
population evaluation, the row-sharded Cholesky, the column-sharded cached
acquisition and the beyond-one-card BO path.  One process per card; the
tests run it over gloo on the CPU."""

from limbo_tpu_torch.parallel import multihost
from limbo_tpu_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                           replicated, shard_batch)
from limbo_tpu_torch.parallel.sharded import (row_sharded_posterior_mean,
                                              sharded_restart_opt)
from limbo_tpu_torch.parallel.sharded_acq import (ShardColsGPView,
                                                  make_sharded_bo_iter,
                                                  shard_cache_cols,
                                                  sharded_query_cached)
from limbo_tpu_torch.parallel.sharded_big import (BigGP, make_big_bo_iter,
                                                  sharded_cache_from_fit)
from limbo_tpu_torch.parallel.sharded_chol import (ShardedGP,
                                                   sharded_cholesky,
                                                   sharded_fit, sharded_query)

__all__ = [
    "make_mesh", "make_mesh_2d", "replicated", "shard_batch",
    "sharded_restart_opt", "row_sharded_posterior_mean", "multihost",
    "ShardedGP", "sharded_cholesky", "sharded_fit", "sharded_query",
    "ShardColsGPView", "make_sharded_bo_iter", "shard_cache_cols",
    "sharded_query_cached",
    "BigGP", "make_big_bo_iter", "sharded_cache_from_fit",
]
