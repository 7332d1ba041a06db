"""Model-protocol dispatch: one query entry point for every model family
(port of limbo_tpu/models/dispatch.py; the GP and its cached view are the
families ported so far)."""

from __future__ import annotations

from typing import Tuple

import torch


def query_any(model, Xq) -> Tuple[torch.Tensor, torch.Tensor]:
    from limbo_tpu_torch.models import gp as gp_mod

    if isinstance(model, gp_mod.GP):
        return gp_mod.query(model, Xq)
    if isinstance(model, gp_mod.CachedGPView):
        return gp_mod.query_cached(model.gp, model.cache, Xq)
    raise TypeError(f"unknown model type {type(model)}")


def add_sample_any(model, x, y):
    """Incremental update for families that support it."""
    from limbo_tpu_torch.models import gp as gp_mod

    if isinstance(model, gp_mod.GP):
        return gp_mod.add_sample(model, x, y)
    raise TypeError(f"add_sample not supported for {type(model)}")
