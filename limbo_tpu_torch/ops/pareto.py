"""Pareto utilities: non-dominated filtering and hypervolume (port of
limbo_tpu/ops/pareto.py).

Reference: src/limbo/experimental/tools/pareto.hpp (dominate_flag:60,
pareto_set:198) and the vendored Zitzler hypervolume code src/hv/hypervol.c
(FilterNondominatedSet, CalculateHypervolume).

Dominance is one (n, n) comparison tensor, masked for padded rows; the 2-D
hypervolume is a sort and a running maximum, over any leading batch axes.
Higher-dimensional hypervolume runs the native C++ sweep on the host
(limbo_tpu_torch.native): a statistic, not an operation of the loop.

Convention: MAXIMIZATION (limbo's BO convention; pareto.hpp compares >=).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def dominance_matrix(Y: torch.Tensor, mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """D[i, j] = True iff point j dominates point i (all >=, any >).

    Y: (n, p) objective values (maximized).  mask: (n,) validity."""
    ge = torch.all(Y[None, :, :] >= Y[:, None, :], dim=-1)         # j >= i
    gt = torch.any(Y[None, :, :] > Y[:, None, :], dim=-1)
    dom = ge & gt
    if mask is not None:
        dom = dom & (mask[None, :] > 0)
    return dom


def non_dominated_mask(Y: torch.Tensor, mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(n,) bool: the point is on the Pareto front (limbo pareto_set)."""
    nd = ~torch.any(dominance_matrix(Y, mask), dim=1)
    if mask is not None:
        nd = nd & (mask > 0)
    return nd


def pareto_set(X: torch.Tensor, Y: torch.Tensor,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The compacted Pareto set: (X', Y', front_mask) with the front's
    points first in their order (a stable sort, as the reference's)."""
    nd = non_dominated_mask(Y, mask)
    order = torch.argsort((~nd).to(torch.int8), stable=True)
    return X[order], Y[order], nd[order]


def hypervolume_2d(Y: torch.Tensor, ref: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact 2-D hypervolume (maximization) dominated by Y above ``ref``.

    Y: (..., n, 2), mask (..., n).  Sorted by objective 0 descending (a
    stable sort), each point adds its width times its rise above the
    running maximum of objective 1 before it."""
    ref = torch.as_tensor(ref, dtype=Y.dtype, device=Y.device)
    y0, y1 = Y[..., 0], Y[..., 1]
    if mask is not None:
        valid = mask > 0
        y0 = torch.where(valid, y0, ref[0])
        y1 = torch.where(valid, y1, ref[1])
    y0 = torch.maximum(y0, ref[0])
    y1 = torch.maximum(y1, ref[1])
    order = torch.argsort(-y0, dim=-1, stable=True)
    y0s = torch.gather(y0, -1, order)
    y1s = torch.gather(y1, -1, order)
    run = torch.cummax(y1s, dim=-1).values
    prev_h = torch.cat([ref[1].expand(run.shape[:-1] + (1,)),
                        run[..., :-1]], dim=-1)
    width = y0s - ref[0]
    height = torch.clamp(y1s - prev_h, min=0.0)
    return torch.sum(width * height, dim=-1)


def hypervolume(Y, ref, mask=None):
    """Hypervolume for p objectives: the exact 2-D sweep on Y's device, the
    native C++ sweep on the host otherwise (limbo_tpu_torch.native)."""
    Y = torch.atleast_2d(torch.as_tensor(Y))
    if Y.shape[1] == 2:
        return hypervolume_2d(Y, torch.as_tensor(ref, dtype=Y.dtype,
                                                 device=Y.device), mask)
    from limbo_tpu_torch.native import hv_host

    Yn = Y.detach().cpu().numpy()
    if mask is not None:
        Yn = Yn[torch.as_tensor(mask).cpu().numpy() > 0]
    ref = (ref.detach().cpu().numpy() if torch.is_tensor(ref)
           else np.asarray(ref, dtype=np.float64))
    return hv_host(Yn, ref)
