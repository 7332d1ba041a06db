"""Small math helpers shared across the framework (port of
limbo_tpu/utils/maths.py).

Pairwise squared distances use the ``|a|^2 + |b|^2 - 2 a.b`` expansion so
the dominant cost is one matrix product.  That product, and its backward,
run in exact f32 in both precision modes (utils/precision.py; the
reference pins it at HIGHEST, limbo_tpu/utils/maths.py:29-34): a TF32
product's ~1e-3 relative error would swamp the cancellation for nearby
points and make dense kernel matrices indefinite.
"""

from __future__ import annotations

import torch

from limbo_tpu_torch.utils import precision


class _ExactCross(torch.autograd.Function):
    """a @ b^T with its forward and backward products in exact f32 (the
    same products autograd's mm backward issues, so the same bits)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with precision.exact():
            return a @ b.T

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with precision.exact():
            if ctx.needs_input_grad[0]:
                ga = g.mm(b)
            if ctx.needs_input_grad[1]:
                gb = a.t().mm(g).t()
        return ga, gb


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d), (m, d) -> (n, m) squared Euclidean distances, clamped at 0
    (the expansion can go slightly negative in finite precision)."""
    a2 = torch.sum(a * a, dim=-1)[:, None]
    b2 = torch.sum(b * b, dim=-1)[None, :]
    ab = _ExactCross.apply(a, b) if precision.fast_mode() else a @ b.T
    return torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero gradient at x == 0 (Matern kernels at coincident
    points: d sqrt(x)/dx diverges at 0)."""
    pos = x > 0.0
    safe = torch.where(pos, x, torch.ones_like(x))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(x))


def masked_identity_gram(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K on valid x valid entries, identity elsewhere (the padded-capacity
    convention: chol(blockdiag(K_n, I)) = blockdiag(chol(K_n), I))."""
    m2 = mask[:, None] * mask[None, :]
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    return K * m2 + (1.0 - m2) * eye


def flatten_params(*parts: torch.Tensor) -> torch.Tensor:
    """Concatenate parameter tensors into one flat vector (limbo h_params)."""
    flats = [torch.ravel(p) for p in parts if p.numel() > 0]
    if not flats:
        return torch.zeros((0,))
    return torch.cat(flats)
