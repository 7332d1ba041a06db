"""Triangular matvec: y = L v / y = L^T v reading ONLY the lower triangle
(port of limbo_tpu/ops/trimv.py).

The "linv" and "deferred" cached updates (models/gp.py add_sample_cached)
take their pivot from two dependent (N, N) matvecs against the maintained
inverse Cholesky factor.  A dense matvec reads the whole buffer, half of
it structural zeros; the kernel (``csrc/trimv.cu``) reads only the
triangle, and sums each output in a fixed order so seeded runs repeat.
"""

from __future__ import annotations

import os

import torch

from limbo_tpu_torch.ops import _cuda
from limbo_tpu_torch.utils.precision import exact_products

# Below this size the dense matvec's full read is cheap and launch overhead
# dominates (the reference's threshold, limbo_tpu/ops/trimv.py:43).
TRIMV_MIN_N = 4096
# opt-out, the counterpart of the reference's LIMBO_TPU_NO_TRIMV
NO_TRIMV_ENV = "LIMBO_TPU_TORCH_NO_TRIMV"


@exact_products
def trimv_plain(L: torch.Tensor, v: torch.Tensor,
                transpose: bool = False) -> torch.Tensor:
    """Plain version of the kernel: the product with L's lower triangle."""
    T = torch.tril(L)
    return (T.T if transpose else T) @ v


def _trimv_pallas(L: torch.Tensor, v: torch.Tensor,
                  transpose: bool = False) -> torch.Tensor:
    """y = tril(L) v (or tril(L)^T v) for a square f32 L.

    CUDA kernel: ``csrc/trimv.cu`` trimv_launch, replacing
    limbo_tpu/ops/trimv.py:_trimv_pallas.  Bound on the H100 by the bytes of
    the triangle (210 MB at N = 10240); deterministic, no float atomics."""
    if L.device.type != "cuda":
        return trimv_plain(L, v, transpose)
    N = L.shape[0]
    if L.ndim != 2 or L.shape[1] != N or v.shape != (N,):
        raise ValueError(f"_trimv_pallas: shapes {tuple(L.shape)}, "
                         f"{tuple(v.shape)}")
    _cuda.check_cuda_f32("_trimv_pallas", L, v)
    y = torch.empty((N,), dtype=torch.float32, device=L.device)
    if N:
        _cuda.launch("trimv", "trimv_launch", "trimv", L.device,
                     L.data_ptr(), v.data_ptr(), N, int(bool(transpose)),
                     y.data_ptr())
    return y


@exact_products
def trimv(L: torch.Tensor, v: torch.Tensor,
          transpose: bool = False) -> torch.Tensor:
    """y = L @ v (or L^T @ v) for lower-triangular L, size-dispatched.

    The triangle kernel runs on the card for a square f32 L with
    N >= TRIMV_MIN_N unless LIMBO_TPU_TORCH_NO_TRIMV is set; everything else
    (the CPU, small N, other dtypes) takes a dense matvec, as in the
    reference (limbo_tpu/ops/trimv.py:130-149)."""
    N = L.shape[0]
    use_kernel = (N >= TRIMV_MIN_N and L.ndim == 2 and L.shape[1] == N
                  and v.shape == (N,) and L.dtype == torch.float32
                  and v.dtype == torch.float32
                  and not os.environ.get(NO_TRIMV_ENV))
    if use_kernel and L.device.type == "cuda":
        return _trimv_pallas(L.contiguous(), v.contiguous(), transpose)
    A = L.T if transpose else L
    return A @ v
