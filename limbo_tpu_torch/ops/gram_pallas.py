"""Fused covariance-tile kernels (port of limbo_tpu/ops/gram_pallas.py).

``gram_pallas`` writes the (n, m) cross-covariance sf2 * rho(r^2) in one
pass; ``gram_train_pallas`` writes the Cholesky-ready padded (N, N)
training covariance (covariance + diag_add on the valid diagonal, identity
on the padding) in one pass.  On a CUDA tensor each launches its CUDA C++
kernel (``csrc/gram.cu``) or raises; on a CPU tensor each runs its plain
PyTorch version below, which computes the same tile formula.

The names keep the reference's so a reader can find each counterpart; the
kernels are Hopper kernels, not Pallas.
"""

from __future__ import annotations

import math

import torch

from limbo_tpu_torch.ops import _cuda
from limbo_tpu_torch.utils.precision import exact_products

FORMS = {"se": 0, "matern32": 1, "matern52": 2}


def _radial(form: str, r2: torch.Tensor, inv_l) -> torch.Tensor:
    """Covariance from squared distance r2 (already length-scaled for se);
    limbo_tpu/ops/gram_pallas.py _radial."""
    if form == "se":
        return torch.exp(-0.5 * r2)
    if form == "matern32":
        d = torch.sqrt(torch.clamp(r2, min=1e-30))
        t = math.sqrt(3.0) * inv_l * d
        return (1.0 + t) * torch.exp(-t)
    if form == "matern52":
        d = torch.sqrt(torch.clamp(r2, min=1e-30))
        t = math.sqrt(5.0) * inv_l * d
        quad = (5.0 / 3.0) * (inv_l * inv_l) * r2
        return (1.0 + t + quad) * torch.exp(-t)
    raise ValueError(form)


@exact_products
def gram_plain(X1, X2, sf2, inv_l, form: str = "se") -> torch.Tensor:
    """Plain version of the gram tile: r2 = max(|a|^2 + |b|^2 - 2 a.b, 0),
    then sf2 * rho(r2)."""
    a2 = torch.sum(X1 * X1, dim=1, keepdim=True)
    b2 = torch.sum(X2 * X2, dim=1, keepdim=True).T
    r2 = torch.clamp(a2 + b2 - 2.0 * (X1 @ X2.T), min=0.0)
    return sf2 * _radial(form, r2, inv_l)


def gram_train_plain(X, sf2, inv_l, diag_add, n: int,
                     form: str = "se") -> torch.Tensor:
    """Plain version of the training tile: cov + diag_add * [i == j] where
    i, j < n, [i == j] elsewhere."""
    N = X.shape[0]
    cov = gram_plain(X, X, sf2, inv_l, form)
    idx = torch.arange(N, device=X.device)
    eye = torch.eye(N, dtype=cov.dtype, device=X.device)
    valid = (idx[:, None] < n) & (idx[None, :] < n)
    return torch.where(valid, cov + diag_add * eye, eye)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 device tensor (the kernels read scalars from the card, so
    no launch waits on a host copy)."""
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(()).contiguous()


def gram_pallas(X1: torch.Tensor, X2: torch.Tensor, sf2, inv_l,
                form: str = "se") -> torch.Tensor:
    """Fused (n, m) covariance block; X1/X2 pre-scaled for `se`, raw for the
    Matern forms (isotropic inv_l applied in the radial profile).

    CUDA kernel: ``csrc/gram.cu`` gram_launch, replacing
    limbo_tpu/ops/gram_pallas.py:gram_pallas.  Bound on the H100 by the
    (n, m) f32 output write; see the source for the design."""
    if form not in FORMS:
        raise ValueError(form)
    if X1.device.type != "cuda":
        return gram_plain(X1, X2, sf2, inv_l, form)
    if X1.ndim != 2 or X2.ndim != 2 or X1.shape[1] != X2.shape[1]:
        raise ValueError(f"gram_pallas: shapes {tuple(X1.shape)}, "
                         f"{tuple(X2.shape)}")
    sf2_t, inv_l_t = _scalar(sf2, X1), _scalar(inv_l, X1)
    _cuda.check_cuda_f32("gram_pallas", X1, X2, sf2_t, inv_l_t)
    n, d = X1.shape
    m = X2.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=X1.device)
    if n and m:
        _cuda.launch("gram", "gram_launch", "gram", X1.device,
                     X1.data_ptr(), X2.data_ptr(), n, m, d, sf2_t.data_ptr(),
                     inv_l_t.data_ptr(), FORMS[form], out.data_ptr())
    return out


def gram_train_pallas(X: torch.Tensor, sf2, inv_l, diag_add, n: int,
                      form: str = "se") -> torch.Tensor:
    """Fused (N, N) padded training covariance of the capacity-padded X
    (N, d), with n valid rows.

    CUDA kernel: ``csrc/gram.cu`` gram_train_launch, replacing
    limbo_tpu/ops/gram_pallas.py:gram_train_pallas.  Bound on the H100 by
    the (N, N) f32 output write (420 MB at N = 10240)."""
    if form not in FORMS:
        raise ValueError(form)
    n = int(n)
    if X.device.type != "cuda":
        return gram_train_plain(X, sf2, inv_l, diag_add, n, form)
    if X.ndim != 2:
        raise ValueError(f"gram_train_pallas: shape {tuple(X.shape)}")
    sf2_t, inv_l_t = _scalar(sf2, X), _scalar(inv_l, X)
    dadd_t = _scalar(diag_add, X)
    _cuda.check_cuda_f32("gram_train_pallas", X, sf2_t, inv_l_t, dadd_t)
    N, d = X.shape
    out = torch.empty((N, N), dtype=torch.float32, device=X.device)
    if N:
        _cuda.launch("gram", "gram_train_launch", "gram_train", X.device,
                     X.data_ptr(), N, d, sf2_t.data_ptr(), inv_l_t.data_ptr(),
                     dadd_t.data_ptr(), n, FORMS[form], out.data_ptr())
    return out


def use_pallas(X1: torch.Tensor, X2: torch.Tensor) -> bool:
    """Dispatch rule (limbo_tpu/ops/gram_pallas.py:use_pallas): the card,
    f32, and n * m >= 512^2, the reference's size threshold, so every call
    takes the path it takes there."""
    if X1.device.type != "cuda" or X2.device.type != "cuda":
        return False
    if X1.dtype != torch.float32 or X2.dtype != torch.float32:
        return False
    return X1.shape[0] * X2.shape[0] >= 512 * 512
