"""Model-protocol dispatch: one query entry point for every model family
(port of limbo_tpu/models/dispatch.py).

limbo's BO loop takes the model as a template parameter (modelfun<...>,
bo_base.hpp:113) so acquisitions work over GP, SparsifiedGP, SPGP, ...;
here ``query_any(model, Xq)`` routes to the family's query, so the
acquisitions and the BO loop accept any model.
"""

from __future__ import annotations

from typing import Tuple

import torch


def query_any(model, Xq) -> Tuple[torch.Tensor, torch.Tensor]:
    from limbo_tpu_torch.models import (gp as gp_mod, iterative, multi_gp,
                                        sparse_gp, spgp)

    if isinstance(model, gp_mod.GP):
        return gp_mod.query(model, Xq)
    if isinstance(model, gp_mod.CachedGPView):
        return gp_mod.query_cached(model.gp, model.cache, Xq)
    if isinstance(model, sparse_gp.SparsifiedGP):
        return gp_mod.query(model.gp, Xq)
    if isinstance(model, spgp.SPGP):
        return spgp.query(model, Xq)
    if isinstance(model, multi_gp.MultiGP):
        return multi_gp.query(model, Xq)
    if isinstance(model, iterative.IterativeGP):
        return iterative.query(model, Xq)
    raise TypeError(f"unknown model type {type(model)}")


def add_sample_any(model, x, y):
    """Incremental update for every family."""
    from limbo_tpu_torch.models import (gp as gp_mod, iterative, multi_gp,
                                        sparse_gp, spgp)

    if isinstance(model, gp_mod.GP):
        return gp_mod.add_sample(model, x, y)
    if isinstance(model, sparse_gp.SparsifiedGP):
        return sparse_gp.add_sample(model, x, y)
    if isinstance(model, multi_gp.MultiGP):
        return multi_gp.add_sample(model, x, y)
    if isinstance(model, spgp.SPGP):
        return spgp.add_sample(model, x, y)
    if isinstance(model, iterative.IterativeGP):
        return iterative.add_sample(model, x, y)
    raise TypeError(f"add_sample not supported for {type(model)}")
