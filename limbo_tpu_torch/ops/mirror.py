"""The bf16 mirror product of the cached query: t = bf16(ks) @ Kq with f32
sums.

The reference reads its low-precision K^{-1} mirror through an XLA dot with
bf16 operands and ``preferred_element_type=f32`` (limbo_tpu/models/gp.py:
496-497, 534-535): the exact products of the bf16 operands, summed in f32.
On a CUDA tensor ``mirror_mm`` launches ``csrc/mirror_mm.cu``, which sums on
the CUDA cores with round-to-nearest FMAs in a fixed order (the card's
mixed-dtype tensor-core GEMM truncates as it accumulates, a bias toward
zero); on a CPU tensor it runs the plain version below.  This kernel is the
port's own: the reference's product is not a Pallas kernel.
"""

from __future__ import annotations

import torch

from limbo_tpu_torch.ops import _cuda

# the kernel's output tile and depth slice (csrc/mirror_mm.cu BM, BN, BK)
_TILE_Q, _TILE_N, _SLICE = 64, 128, 32
# enough blocks for two per SM of an H100 (132 SMs)
_TARGET_BLOCKS = 264


def _depth_split(q: int, K: int, N: int):
    """(splits, chunk): cut the depth into chunks (multiples of the slice)
    when the (q, N) tiles alone hold fewer blocks than the target, keeping
    each chunk at least 8 slices deep."""
    tiles = -(-q // _TILE_Q) * -(-N // _TILE_N)
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles), K // (8 * _SLICE)))
    chunk = -(-K // splits)
    chunk = -(-chunk // _SLICE) * _SLICE
    return -(-K // chunk) if K else 1, max(chunk, _SLICE)


def mirror_mm_plain(ks: torch.Tensor, Kq: torch.Tensor) -> torch.Tensor:
    """Plain version: round ks to Kq's dtype, then multiply the operands
    upcast to ks's dtype (the same exact products, summed in that dtype)."""
    return ks.to(Kq.dtype).to(ks.dtype) @ Kq.to(ks.dtype)


def mirror_mm(ks: torch.Tensor, Kq: torch.Tensor) -> torch.Tensor:
    """(q, N) = bf16(ks) (q, K) @ Kq (K, N) bf16, summed in ks's dtype
    (f32 on the card).

    CUDA kernel: ``csrc/mirror_mm.cu`` mirror_mm_launch.  Bound on the H100
    by the mirror's bytes at q = 64 and by 2 q K N operations at the bf16
    tensor-core rate at q = 1024; the design sums on CUDA cores, whose f32
    rate is its own ceiling.  See the source for the design."""
    if ks.device.type != "cuda":
        return mirror_mm_plain(ks, Kq)
    if (ks.ndim != 2 or Kq.ndim != 2 or ks.shape[1] != Kq.shape[0]):
        raise ValueError(f"mirror_mm: shapes {tuple(ks.shape)}, "
                         f"{tuple(Kq.shape)}")
    if Kq.dtype != torch.bfloat16:
        raise ValueError(f"mirror_mm: the mirror must be bfloat16, got "
                         f"{Kq.dtype}")
    if Kq.device != ks.device or not Kq.is_contiguous():
        raise ValueError("mirror_mm: the mirror must be a contiguous tensor "
                         "on the device of ks")
    _cuda.check_cuda_f32("mirror_mm", ks)
    q, K = ks.shape
    N = Kq.shape[1]
    out = torch.empty((q, N), dtype=torch.float32, device=ks.device)
    if q and N:
        splits, chunk = _depth_split(q, K, N)
        work = torch.empty((splits, q, N) if splits > 1 else (0,),
                           dtype=torch.float32, device=ks.device)
        _cuda.launch("mirror_mm", "mirror_mm_launch", "mirror_mm", ks.device,
                     ks.data_ptr(), Kq.data_ptr(), q, K, N, splits, chunk,
                     work.data_ptr(), out.data_ptr())
    return out
