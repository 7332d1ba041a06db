"""Cholesky factorization and blocked triangular inverse (port of
limbo_tpu/ops/chol.py).

* ``cholesky`` is ``torch.linalg.cholesky_ex`` at every size, the
  counterpart of the reference's stock path off the TPU
  (limbo_tpu/ops/chol.py:375-381).  An indefinite input gives an all-NaN
  factor instead of raising, as XLA's Cholesky does, so ``recompute``'s
  jitter-escalation retry sees it.
* ``tri_inv_blocked`` inverts a lower-triangular matrix by block forward
  substitution.  The inverses of ALL diagonal blocks come from one launch of
  the tri-inv panel kernel (``csrc/tri_inv.cu``; they are independent), and
  each block row is then two large products, left to ``torch.matmul`` in
  exact f32 as the reference leaves them to XLA (chol.py:361-366).

The reference's blocked Cholesky (``cholesky_blocked`` with the
panel-factor kernel) and its custom pullback are not ported yet.
"""

from __future__ import annotations

import torch

from limbo_tpu_torch.ops import _cuda

# the blocked triangular inverse switches on at the reference's size
# (limbo_tpu/ops/chol.py:66), on the card
TRI_INV_MIN_N = 4096
# The reference's B = 256 was a TPU choice: one f32 block is 256 KiB there,
# above the 227 KB of shared memory a Hopper block may use.  The port's
# panel kernel keeps a block's triangle and its inverse resident, 128 KB,
# and is compiled for this block only; the plain version takes any block.
TRI_INV_BLOCK = 128


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, row-major; NaN everywhere when A is not
    positive definite (no host sync: the check stays on the device)."""
    L, info = torch.linalg.cholesky_ex(A)
    L.masked_fill_((info != 0)[..., None, None], float("nan"))
    return L.contiguous()


def _diag_blocks(L: torch.Tensor, block: int) -> torch.Tensor:
    """(N, N) -> (N/B, B, B) view of the diagonal blocks."""
    nb = L.shape[0] // block
    return L.reshape(nb, block, nb, block).diagonal(dim1=0, dim2=2) \
        .permute(2, 0, 1)


def tri_inv_panel_plain(L: torch.Tensor, block: int) -> torch.Tensor:
    """Plain version of the panel kernel: forward substitution, row by row,
    for every diagonal block at once."""
    D = torch.tril(_diag_blocks(L, block))
    X = torch.zeros_like(D)
    for r in range(block):
        acc = -(D[:, r:r + 1, :r] @ X[:, :r, :])[:, 0, :]        # (nb, B)
        acc[:, r] += 1.0
        X[:, r, :] = acc / D[:, r, r:r + 1]
    return X


def _tri_inv_panel(L: torch.Tensor, block: int = TRI_INV_BLOCK
                   ) -> torch.Tensor:
    """(N/B, B, B): the inverse of each (B, B) diagonal block of the
    lower-triangular L (N, N); N must be a multiple of B.

    CUDA kernel: ``csrc/tri_inv.cu`` tri_inv_panel_launch, replacing
    limbo_tpu/ops/chol.py:_tri_inv_panel, one grid over all diagonal blocks.
    Bound on the H100 by the latency of the substitution chain."""
    N = L.shape[0]
    if L.ndim != 2 or L.shape[1] != N or N % block:
        raise ValueError(f"_tri_inv_panel: shape {tuple(L.shape)} with "
                         f"block {block}")
    if L.device.type != "cuda":
        return tri_inv_panel_plain(L, block)
    if block != TRI_INV_BLOCK:
        raise ValueError(f"_tri_inv_panel: the kernel's block is "
                         f"{TRI_INV_BLOCK}, got {block}")
    _cuda.check_cuda_f32("_tri_inv_panel", L)
    out = torch.empty((N // block, block, block), dtype=torch.float32,
                      device=L.device)
    if N:
        _cuda.launch("tri_inv", "tri_inv_panel_launch", "tri_inv_panel",
                     L.device, L.data_ptr(), N, out.data_ptr())
    return out


def _pad_identity(A: torch.Tensor, block: int):
    """Extend A to a multiple of `block` with an identity diagonal block."""
    n = A.shape[0]
    npad = -(-n // block) * block
    if npad == n:
        return A, n
    P = torch.eye(npad, dtype=A.dtype, device=A.device)
    P[:n, :n] = A
    return P, n


def tri_inv_blocked(L: torch.Tensor, block: int = TRI_INV_BLOCK
                    ) -> torch.Tensor:
    """Inverse of a lower-triangular matrix by block forward substitution.

    Block row i of X = L^{-1}:
        X[i, :iB] = -Lii^{-1} @ L[i-row, :iB] @ X[:iB, :iB]
        X[i, iB:(i+1)B] = Lii^{-1}
    """
    L, n = _pad_identity(L, block)
    L = L.contiguous()
    N = L.shape[0]
    Dinv = _tri_inv_panel(L, block)                         # (nb, B, B)
    X = torch.zeros((N, N), dtype=L.dtype, device=L.device)
    for i in range(N // block):
        j0, j1 = i * block, (i + 1) * block
        if i > 0:
            S = L[j0:j1, :j0] @ X[:j0, :j0]
            X[j0:j1, :j0] = -(Dinv[i] @ S)
        X[j0:j1, j0:j1] = Dinv[i]
    return X[:n, :n]


def use_blocked_tri(n: int, device: torch.device) -> bool:
    """The blocked inverse runs on the card from TRI_INV_MIN_N up;
    elsewhere the library triangular solve is used."""
    return torch.device(device).type == "cuda" and n >= TRI_INV_MIN_N


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """L^{-1} for lower-triangular L, size-dispatched (TRI_INV_MIN_N)."""
    if L.dtype == torch.float32 and use_blocked_tri(L.shape[0], L.device):
        return tri_inv_blocked(L)
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)
