from limbo_tpu_torch.ops.chol import cholesky, tri_inv, tri_inv_blocked

__all__ = ["cholesky", "tri_inv", "tri_inv_blocked"]
