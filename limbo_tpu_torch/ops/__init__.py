from limbo_tpu_torch.ops.chol import (cholesky, cholesky_blocked, tri_inv,
                                      tri_inv_blocked)
from limbo_tpu_torch.ops.ehvi import (ehvi_2d_max, ehvi_2d_min, ehvi_3d_max,
                                      ehvi_3d_min, ehvi_max, ehvi_mc_max,
                                      nondominated_boxes, qehvi_mc_max)
from limbo_tpu_torch.ops.pareto import (dominance_matrix, hypervolume,
                                        hypervolume_2d, non_dominated_mask,
                                        pareto_set)

__all__ = [
    "dominance_matrix", "non_dominated_mask", "pareto_set",
    "hypervolume", "hypervolume_2d",
    "ehvi_2d_min", "ehvi_2d_max", "ehvi_3d_min", "ehvi_3d_max", "ehvi_max",
    "ehvi_mc_max", "qehvi_mc_max", "nondominated_boxes",
    "cholesky", "cholesky_blocked", "tri_inv", "tri_inv_blocked",
]
