"""The bf16 mirror product of the cached query: t = bf16(ks) @ Kq with f32
sums.

The reference reads its low-precision K^{-1} mirror through an XLA dot with
bf16 operands and ``preferred_element_type=f32`` (limbo_tpu/models/gp.py:
496-497, 534-535): the exact products of the bf16 operands, summed in f32.
On a CUDA tensor ``mirror_mm`` launches ``csrc/mirror_mm.cu``, which takes
the products on the tensor cores and promotes each ``PROMOTION``-deep
partial sum to an f32 accumulator with a round-to-nearest add, in a fixed
order (the card's tensor-core accumulation truncates, a bias toward zero
that would otherwise grow with the depth); on a CPU tensor it runs the
plain version below.  This kernel is the port's own: the reference's
product is not a Pallas kernel.
"""

from __future__ import annotations

import functools

import torch

from limbo_tpu_torch.ops import _cuda
from limbo_tpu_torch.utils.precision import exact_products

# the promotion interval: the depth each tensor-core partial sum covers
# before it is added to the f32 accumulator (csrc/mirror_mm.cu PK)
PROMOTION = 64
# the kernel's column tile and depth slice (csrc/mirror_mm.cu BN, BK)
_TILE_N, _SLICE = 128, 64


def _row_tile(q: int) -> int:
    """The kernel's row tile: 64 (two blocks an SM) up to q = 64, else 128
    (one block an SM)."""
    return 64 if q <= 64 else 128


def _depth_split(q: int, K: int, N: int, sms: int, bm: int):
    """(splits, chunk): cut the depth into chunks (multiples of the slice)
    when the (q, N) tiles alone hold fewer blocks than the SMs keep
    resident, without going past that count (no second wave) and keeping
    each chunk at least 8 slices deep."""
    resident = sms * (2 if bm == 64 else 1)
    tiles = -(-q // bm) * -(-N // _TILE_N)
    splits = max(1, min(resident // tiles, K // (8 * _SLICE)))
    chunk = -(-K // splits)
    chunk = max(-(-chunk // _SLICE) * _SLICE, _SLICE)
    return -(-K // chunk) if K else 1, chunk


@functools.lru_cache(maxsize=None)
def _plan(q: int, K: int, N: int, device_index: int):
    """(row tile, splits, chunk, offset of the partial sums, workspace
    bytes) for one shape on one card, worked out once: the wrapper runs 22
    times a BO iteration on the host's clock.  The workspace holds the bf16
    copy of ks, then (from a 256-byte boundary) the chunks' partial sums."""
    bm = _row_tile(q)
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    splits, chunk = _depth_split(q, K, N, sms, bm)
    a16 = -(-q // bm) * bm * -(-K // _SLICE) * _SLICE * 2
    off = -(-a16 // 256) * 256
    return bm, splits, chunk, off, off + (splits * q * N * 4 if splits > 1
                                          else 0)


@exact_products
def mirror_mm_plain(ks: torch.Tensor, Kq: torch.Tensor) -> torch.Tensor:
    """Plain version: round ks to Kq's dtype, then multiply the operands
    upcast to ks's dtype (the same exact products, summed in that dtype)."""
    return ks.to(Kq.dtype).to(ks.dtype) @ Kq.to(ks.dtype)


def mirror_mm(ks: torch.Tensor, Kq: torch.Tensor) -> torch.Tensor:
    """(q, N) = bf16(ks) (q, K) @ Kq (K, N) bf16, summed in ks's dtype
    (f32 on the card).

    CUDA kernel: ``csrc/mirror_mm.cu`` mirror_mm_launch.  Bound on the H100
    by the mirror's bytes at q = 64 and by 2 q K N operations at the bf16
    tensor-core rate at q = 1024.  See the source for the design."""
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
        bm, splits, chunk, off, size = _plan(q, K, N, ks.device.index)
        ws = torch.empty((size,), dtype=torch.uint8, device=ks.device)
        base = ws.data_ptr()
        _cuda.launch("mirror_mm", "mirror_mm_launch", "mirror_mm", ks.device,
                     ks.data_ptr(), Kq.data_ptr(), q, K, N, bm, splits, chunk,
                     base, base + off, out.data_ptr())
    return out
