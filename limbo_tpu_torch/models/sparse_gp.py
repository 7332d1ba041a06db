"""SparsifiedGP: subset-of-data GP with density-based point removal (port
of limbo_tpu/models/sparse_gp.py).

Reference: src/limbo/model/sparsified_gp.hpp:72.  When the dataset exceeds
``max_points`` (default 200), the densest point is removed, one at a time,
where density(i) is the sum of the d nearest-neighbour distances of point
i (d = input dim; _get_most_dense_point, sparsified_gp.hpp:126); then the
exact GP is fitted on the survivors.

One pairwise-distance matrix, then per removal a masked ``topk`` (the d
smallest, ascending, summed in that order as the reference's
``-top_k(-dm)``), an ``argmin`` (first index on ties, in both packages)
and a mask update at the device index.  The number of removals,
n - max_points, is known on the host, so the loop reads nothing from the
card.  Survivors move to the front of the padded buffers by a stable sort,
keeping the GP's padded-prefix invariant.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.utils.device import resolve_device
from limbo_tpu_torch.utils.maths import safe_sqrt, sq_dist

DEFAULT_MAX_POINTS = 200  # limbo defaults::model_sparse_gp::max_points


def sparsify(X: torch.Tensor, Y: torch.Tensor, n: int, max_points: int
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Compacted (X, Y, n') with at most max_points valid rows.

    X: (N, d) padded, Y: (N, p) padded, n: the valid count."""
    N, d = X.shape
    dist = safe_sqrt(sq_dist(X, X))
    big = torch.finfo(X.dtype).max
    off_diag = ~torch.eye(N, dtype=torch.bool, device=X.device)
    mask = torch.arange(N, device=X.device) < n
    for _ in range(n - max_points):
        valid2 = mask[:, None] & mask[None, :] & off_diag
        dm = torch.where(valid2, dist, torch.full_like(dist, big))
        smallest = torch.topk(dm, d, dim=1, largest=False, sorted=True).values
        density = torch.sum(smallest, dim=1)
        density = torch.where(mask, density, torch.full_like(density, big))
        mask = mask.index_fill(0, torch.argmin(density).reshape(1), False)
    n_new = min(n, max_points)
    # stable compaction: kept points first, in their original order
    order = torch.sort((~mask).to(torch.uint8), stable=True).indices
    keep = mask[order].to(X.dtype)
    return X[order] * keep[:, None], Y[order] * keep[:, None], n_new


@dataclass
class SparsifiedGP:
    """An exact GP and its sparsification budget (limbo's SparsifiedGP
    subclass)."""

    gp: gp_mod.GP
    max_points: int = DEFAULT_MAX_POINTS

    replace = replace

    @property
    def n(self):
        return self.gp.n

    @property
    def n_dev(self):
        return self.gp.n_dev

    @property
    def x(self):
        return self.gp.x

    @property
    def y(self):
        return self.gp.y

    @property
    def mask(self):
        return self.gp.mask

    @property
    def dim_in(self):
        return self.gp.dim_in

    @property
    def dim_out(self):
        return self.gp.dim_out

    def query(self, Xq):
        return gp_mod.query(self.gp, Xq)


def _refit(g: gp_mod.GP, max_points: int) -> gp_mod.GP:
    Xc, Yc, n_new = sparsify(g.x, g.y, g.n, max_points)
    return gp_mod.recompute(g.replace(x=Xc, y=Yc, n=n_new, n_dev=None))


def fit(kernel, mean, X, Y, max_points: int = DEFAULT_MAX_POINTS,
        capacity: Optional[int] = None, device="cuda",
        dtype=None) -> SparsifiedGP:
    """Sparsify if needed, then fit (sparsified_gp.hpp compute():84-100)."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    dtype = dtype if dtype is not None else (
        X.dtype if X.is_floating_point() else torch.float32)
    X = torch.atleast_2d(X.to(dtype))
    Y = torch.atleast_2d(torch.as_tensor(Y, device=dev).to(dtype))
    n, d = X.shape
    N = capacity if capacity is not None else gp_mod._round_capacity(n)
    xpad = torch.zeros((N, d), dtype=dtype, device=dev)
    xpad[:n] = X
    ypad = torch.zeros((N, Y.shape[1]), dtype=dtype, device=dev)
    ypad[:n] = Y
    g = gp_mod.GP(kernel=kernel, mean=mean, x=xpad, y=ypad, n=n,
                  L=torch.eye(N, dtype=dtype, device=dev),
                  alpha=torch.zeros((N, Y.shape[1]), dtype=dtype, device=dev))
    return SparsifiedGP(gp=_refit(g, max_points), max_points=max_points)


def add_sample(sgp: SparsifiedGP, x_new, y_new) -> SparsifiedGP:
    """Rank-1 append; over budget, re-sparsify and refit
    (sparsified_gp.hpp add_sample:104-121)."""
    g = gp_mod.add_sample(sgp.gp, x_new, y_new)
    if g.n > sgp.max_points:
        g = _refit(g, sgp.max_points)
    return sgp.replace(gp=g)
