"""Distributed large-n GP: row-sharded CG over the mesh (port of
limbo_tpu/parallel/distributed_gp.py).

The kernel matvec at the heart of the iterative GP (models/iterative.py)
splits its rows over the ranks: each rank builds the gram rows of its
share of the training points against all of them (the gram kernel on the
card), multiplies them into its rows of the product, and an all_gather
assembles the product on every rank.  The CG state stays replicated, so
only the O(n^2) gram work is split, and no rank holds more than its
(n / D, n) rows of K at once.
"""

from __future__ import annotations

from typing import Optional

import torch

from limbo_tpu_torch.kernels.base import JITTER
from limbo_tpu_torch.models.iterative import cg_solve
from limbo_tpu_torch.parallel.mesh import all_gather, mesh_axis
from limbo_tpu_torch.parallel.sharded import _rows


def sharded_kernel_matvec(mesh, kernel, X: torch.Tensor, mask: torch.Tensor,
                          noise_var, V: torch.Tensor,
                          axis: Optional[str] = None) -> torch.Tensor:
    """(K + (noise + jitter) I) @ V with the training rows split over
    `axis`.  X: (n, d), mask: (n,), V: (n, q), all replicated; n must be a
    multiple of the axis size.  The result is replicated."""
    ax = mesh_axis(mesh, axis)
    r = _rows(ax, X.shape[0])
    G = kernel.gram(X[r], X) * mask[None, :] * mask[r, None]
    full = all_gather(G @ (V * mask[:, None]), ax)            # (n, q)
    diag = (noise_var + JITTER) * mask + (1.0 - mask)
    return full + diag[:, None] * V


def sharded_cg_fit_alpha(mesh, kernel, X: torch.Tensor, mask: torch.Tensor,
                         centered: torch.Tensor, tol: float = 1e-5,
                         maxiter: int = 256,
                         axis: Optional[str] = None) -> torch.Tensor:
    """alpha = K^{-1} centered by CG (models/iterative.cg_solve) with the
    matvec split over the mesh.  Every rank takes the same convergence
    decisions: the residuals are replicated."""

    def matvec(V):
        return sharded_kernel_matvec(mesh, kernel, X, mask, kernel.noise, V,
                                     axis=axis)

    alpha, _ = cg_solve(matvec, centered, tol, maxiter)
    return alpha
