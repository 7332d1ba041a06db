"""Dispatching gram builders: fused kernel forward, reference-form backward
(port of limbo_tpu/ops/gram.py).

Forward covariance blocks go through the fused CUDA kernels when
``use_pallas`` says so (the card, f32, n * m >= 512^2); the backward
recomputes through the plain reference formula with autograd, exactly as
the reference's custom VJPs do, so the kernels need no backward of their
own.
"""

from __future__ import annotations

import math

import torch

from limbo_tpu_torch.ops.gram_pallas import (gram_pallas, gram_train_pallas,
                                             use_pallas)
from limbo_tpu_torch.utils.maths import safe_sqrt, sq_dist

# -- reference forms ---------------------------------------------------------


def se_gram_ref(X1s, X2s, sf2):
    return sf2 * torch.exp(-0.5 * sq_dist(X1s, X2s))


def matern32_gram_ref(X1, X2, sf2, inv_l):
    d = safe_sqrt(sq_dist(X1, X2))
    t = (math.sqrt(3.0) * inv_l) * d
    return sf2 * (1.0 + t) * torch.exp(-t)


def matern52_gram_ref(X1, X2, sf2, inv_l):
    d2 = sq_dist(X1, X2)
    d = safe_sqrt(d2)
    t = (math.sqrt(5.0) * inv_l) * d
    quad = (5.0 / 3.0) * (inv_l * inv_l) * d2
    return sf2 * (1.0 + t + quad) * torch.exp(-t)


_GRAM_REFS = {"se": lambda a, b, s, il: se_gram_ref(a, b, s),
              "matern32": matern32_gram_ref, "matern52": matern52_gram_ref}


# -- training covariance (gram + diag add + masked-identity padding) --------

def train_assemble(K: torch.Tensor, diag_add, n: int) -> torch.Tensor:
    """K + diag_add*I on the valid block, identity on the padded block
    (== masked_identity_gram(K + diag_add*I, mask))."""
    N = K.shape[0]
    idx = torch.arange(N, device=K.device)
    m2 = (idx[:, None] < n) & (idx[None, :] < n)
    eye = torch.eye(N, dtype=K.dtype, device=K.device)
    return torch.where(m2, K + diag_add * eye, eye)


def se_train_ref(Xs, sf2, inv_l, diag_add, n):     # inv_l unused (pre-scaled)
    return train_assemble(se_gram_ref(Xs, Xs, sf2), diag_add, n)


def matern32_train_ref(X, sf2, inv_l, diag_add, n):
    return train_assemble(matern32_gram_ref(X, X, sf2, inv_l), diag_add, n)


def matern52_train_ref(X, sf2, inv_l, diag_add, n):
    return train_assemble(matern52_gram_ref(X, X, sf2, inv_l), diag_add, n)


_TRAIN_REFS = {"se": se_train_ref, "matern32": matern32_train_ref,
               "matern52": matern52_train_ref}


# -- fused forward + reference backward --------------------------------------

def _ref_vjp(ref, inputs, g, needs):
    """Gradients of ref(*inputs) against cotangent g for the inputs marked
    in `needs` (None elsewhere): the backward of every fused forward."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(nd) if torch.is_tensor(x) else x
                  for x, nd in zip(inputs, needs)]
        out = ref(*leaves)
        wrt = [x for x, nd in zip(leaves, needs) if nd]
        grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True)
                     if wrt else ())
    return tuple(next(grads) if nd else None for nd in needs)


class _GramFast(torch.autograd.Function):
    """gram_pallas forward; backward through the reference form
    (limbo_tpu/ops/gram.py:44-79)."""

    @staticmethod
    def forward(ctx, X1, X2, sf2, inv_l, form):
        ctx.save_for_backward(X1, X2, sf2, inv_l)
        ctx.form = form
        return gram_pallas(X1.contiguous(), X2.contiguous(), sf2, inv_l,
                           form=form)

    @staticmethod
    def backward(ctx, g):
        needs = list(ctx.needs_input_grad[:4])
        grads = _ref_vjp(_GRAM_REFS[ctx.form], ctx.saved_tensors, g, needs)
        return (*grads, None)


class _TrainFast(torch.autograd.Function):
    """gram_train_pallas forward; backward through the reference assembly
    (limbo_tpu/ops/gram.py:111-130)."""

    @staticmethod
    def forward(ctx, X, sf2, inv_l, diag_add, n, form):
        ctx.save_for_backward(X, sf2, inv_l, diag_add)
        ctx.n, ctx.form = n, form
        return gram_train_pallas(X.contiguous(), sf2, inv_l, diag_add, n,
                                 form=form)

    @staticmethod
    def backward(ctx, g):
        n, ref = ctx.n, _TRAIN_REFS[ctx.form]
        needs = list(ctx.needs_input_grad[:4])
        grads = _ref_vjp(lambda a, b, c, d: ref(a, b, c, d, n),
                         ctx.saved_tensors, g, needs)
        return (*grads, None, None)


def _as(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def gram_train_masked(form: str, X: torch.Tensor, sf2, inv_l, diag_add,
                      n: int) -> torch.Tensor:
    """(N, N) Cholesky-ready padded training covariance: one fused kernel
    pass on the card, the composed reference form elsewhere."""
    sf2, inv_l, diag_add = _as(sf2, X), _as(inv_l, X), _as(diag_add, X)
    n = int(n)
    if use_pallas(X, X):
        return _TrainFast.apply(X, sf2, inv_l, diag_add, n, form)
    return _TRAIN_REFS[form](X, sf2, inv_l, diag_add, n)


# -- public dispatchers ------------------------------------------------------

def se_gram(X1s, X2s, sf2):
    """(n, m) SE covariance from pre-scaled inputs."""
    if use_pallas(X1s, X2s):
        return _GramFast.apply(X1s, X2s, _as(sf2, X1s),
                               torch.ones((), dtype=X1s.dtype,
                                          device=X1s.device), "se")
    return se_gram_ref(X1s, X2s, sf2)


def matern32_gram(X1, X2, sf2, inv_l):
    if use_pallas(X1, X2):
        return _GramFast.apply(X1, X2, _as(sf2, X1), _as(inv_l, X1),
                               "matern32")
    return matern32_gram_ref(X1, X2, sf2, inv_l)


def matern52_gram(X1, X2, sf2, inv_l):
    if use_pallas(X1, X2):
        return _GramFast.apply(X1, X2, _as(sf2, X1), _as(inv_l, X1),
                               "matern52")
    return matern52_gram_ref(X1, X2, sf2, inv_l)
