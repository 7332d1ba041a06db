"""Inner-optimizer protocol (port of limbo_tpu/opt/base.py).

limbo's functor protocol (src/limbo/opt/optimizer.hpp:61) maximizes f from
a start point.  Here an optimizer is a dataclass with static config, called
as

    result = optimizer(fun, init, generator, bounded)

where ``fun`` maps a (R, d) batch of points to their (R,) values and is
differentiable with autograd (gradient-based optimizers differentiate the
batch sum, which gives every row its own gradient since rows are
independent), ``init`` is a (d,) start or a (R, d) batch of starts,
``generator`` is the ``torch.Generator`` of any draw, and ``bounded``
restricts the search to [0, 1]^d.  A batch of restarts is one tensor, the
counterpart of the reference's vmap.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class OptResult:
    x: torch.Tensor       # (d,) best point found, or (R, d) for a batch
    value: torch.Tensor   # f(x): scalar, or (R,) for a batch


def take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-d index tensor on t's device (an argmax), without the
    host read that Python indexing with a 0-d tensor makes: the optimizers
    run inside a captured BO iteration (bo/graph.py)."""
    return t.index_select(0, i.reshape(1))[0]


def clip01(x: torch.Tensor, bounded: bool) -> torch.Tensor:
    """Project onto [0,1]^d when bounded (limbo rprop.hpp:100-105 clamps)."""
    return torch.clamp(x, 0.0, 1.0) if bounded else x
