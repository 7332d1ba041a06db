"""Blocked Cholesky factorization, its pullback, and the blocked triangular
inverse (port of limbo_tpu/ops/chol.py).

* ``cholesky(A, block, min_blocked)`` is the reference's size dispatch
  (limbo_tpu/ops/chol.py:375-395): on the card, in f32, from
  ``BLOCKED_MIN_N`` up, the left-looking ``cholesky_blocked``; elsewhere
  ``torch.linalg.cholesky_ex``.  ``min_blocked`` forces the blocked path from
  that size, on any device, as the reference's does.  An indefinite input
  gives a NaN factor instead of raising, as XLA's Cholesky does (all NaN from
  ``cholesky_ex``; NaN from the failed pivot on from the blocked path, whose
  GEMMs carry it into every later panel), so ``recompute``'s
  jitter-escalation retry sees it.  It is differentiable at every size
  through the reference's custom pullback (chol.py:407-440), whose L^{-1}
  comes from ``tri_inv``.
* ``cholesky_blocked`` factors one block column at a time: one GEMM for the
  deferred update of the panel, the panel-factor kernel
  (``csrc/panel_factor.cu``) for the (B, B) diagonal block and its inverse,
  and one GEMM for the rest of the panel.  The GEMMs are ``torch.matmul``
  in exact f32, as the reference leaves them to XLA (chol.py:319-332).
* ``tri_inv_blocked`` inverts a lower-triangular matrix by block forward
  substitution.  The inverses of ALL diagonal blocks come from one launch of
  the tri-inv panel kernel (``csrc/tri_inv.cu``; they are independent), and
  each block row is then two large products, left to ``torch.matmul`` in
  exact f32 as the reference leaves them to XLA (chol.py:361-366).

f64 never reaches a kernel: the default dispatch factors it with
``cholesky_ex`` and inverts it with the library triangular solve.
"""

from __future__ import annotations

import torch

from limbo_tpu_torch.ops import _cuda

# the blocked factorization switches on at the reference's size
# (limbo_tpu/ops/chol.py:62), on the card, in f32
BLOCKED_MIN_N = 12288
# the blocked triangular inverse switches on at the reference's size
# (limbo_tpu/ops/chol.py:66), on the card
TRI_INV_MIN_N = 4096
# The reference's B = 256 was a TPU choice: one f32 block is 256 KiB there,
# above the 227 KB of shared memory a Hopper block may use.  The port's
# panel kernels keep two B x B f32 buffers resident (and the tri-inv kernel
# half of a third), 128 KB and more at B = 128, and are compiled for this
# block only.  The plain panel factor takes any block; the plain tri-inv
# any power-of-two multiple of TRI_INV_SUB, the kernel's diagonal
# sub-block, one warp's width.
TRI_INV_BLOCK = 128
PANEL_BLOCK = 128
TRI_INV_SUB = 32


def _stock_cholesky(A: torch.Tensor) -> torch.Tensor:
    """``cholesky_ex``, NaN everywhere when A is not positive definite (no
    host sync: the check stays on the device)."""
    L, info = torch.linalg.cholesky_ex(A)
    L.masked_fill_((info != 0)[..., None, None], float("nan"))
    return L.contiguous()


def panel_factor_plain(D: torch.Tensor):
    """Plain version of the panel kernel, the reference's non-Pallas path
    (chol.py:278-281): (L11, L11^{-T}) from the stock Cholesky and a
    triangular solve."""
    L11 = _stock_cholesky(D)
    eye = torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
    L11inv = torch.linalg.solve_triangular(L11, eye, upper=False)
    return L11, L11inv.T


def _panel_factor_pallas(D: torch.Tensor):
    """(B, B) SPD block -> (L11, L11^{-T}): L11 lower, L11^{-T} upper.  D
    may be a row-strided view (the top of a panel of A).

    CUDA kernel: ``csrc/panel_factor.cu`` panel_factor_launch, replacing
    limbo_tpu/ops/chol.py:_panel_factor_pallas.  Bound on the H100 by the
    latency of its B dependent pivot steps.  A negative pivot gives NaN from
    that pivot on, not clamped (chol.py:87-90)."""
    B = D.shape[0]
    if D.ndim != 2 or D.shape[1] != B:
        raise ValueError(f"_panel_factor_pallas: shape {tuple(D.shape)}")
    if D.device.type != "cuda":
        return panel_factor_plain(D)
    if B != PANEL_BLOCK:
        raise ValueError(f"_panel_factor_pallas: the kernel's block is "
                         f"{PANEL_BLOCK}, got {B}")
    if D.stride(1) != 1:
        raise ValueError("_panel_factor_pallas: expected unit column stride")
    _cuda.check_cuda_f32("_panel_factor_pallas", D[0])
    lt = torch.empty((B, B), dtype=torch.float32, device=D.device)
    v = torch.empty((B, B), dtype=torch.float32, device=D.device)
    _cuda.launch("panel_factor", "panel_factor_launch", "panel_factor",
                 D.device, D.data_ptr(), D.stride(0), lt.data_ptr(),
                 v.data_ptr())
    return lt.T, v


def panel_factor(D: torch.Tensor, use_pallas: bool = True):
    """Factor + invert a small diagonal block: returns (L11, L11^{-1})."""
    factor = _panel_factor_pallas if use_pallas else panel_factor_plain
    L11, L11invT = factor(D)
    return L11, L11invT.T


def _diag_blocks(L: torch.Tensor, block: int) -> torch.Tensor:
    """(N, N) -> (N/B, B, B) view of the diagonal blocks."""
    nb = L.shape[0] // block
    return L.reshape(nb, block, nb, block).diagonal(dim1=0, dim2=2) \
        .permute(2, 0, 1)


def tri_inv_panel_plain(L: torch.Tensor, block: int) -> torch.Tensor:
    """Plain version of the panel kernel, in the kernel's order, for every
    diagonal block at once: the inverses of the 32 x 32 diagonal sub-blocks
    by column-oriented substitution (x_m *= 1 / L_mm, then x_r -= L_rm x_m
    for r > m), then merges by recursive doubling: for halves of width
    h = 32, 64, ..., X21 = -X22 (L21 X11).  The block must be a power-of-two
    multiple of 32."""
    W = TRI_INV_SUB
    s = block // W
    if block % W or s & (s - 1):
        raise ValueError(f"tri_inv_panel_plain: the block must be a "
                         f"power-of-two multiple of {W}, got {block}")
    nb = L.shape[0] // block
    D = torch.tril(_diag_blocks(L, block))
    # the s diagonal sub-blocks of every block, (nb, s, W, W)
    Dd = D.reshape(nb, s, W, s, W).diagonal(dim1=1, dim2=3) \
        .permute(0, 3, 1, 2)
    rcp = 1.0 / torch.diagonal(Dd, dim1=-2, dim2=-1)            # (nb, s, W)
    Xd = torch.eye(W, dtype=L.dtype, device=L.device) \
        .expand(nb, s, W, W).clone()
    for m in range(W):
        Xd[:, :, m, :] *= rcp[:, :, m:m + 1]
        Xd[:, :, m + 1:, :] -= Dd[:, :, m + 1:, m:m + 1] * Xd[:, :, m:m + 1, :]
    X = torch.zeros_like(D)
    for i in range(s):
        X[:, i * W:(i + 1) * W, i * W:(i + 1) * W] = torch.tril(Xd[:, i])
    h = W
    while h < block:
        for a in range(0, block, 2 * h):
            b, e = a + h, a + 2 * h
            T = D[:, b:e, a:b] @ X[:, a:b, a:b]
            X[:, b:e, a:b] = -(X[:, b:e, b:e] @ T)
        h *= 2
    return X


def _tri_inv_panel(L: torch.Tensor, block: int = TRI_INV_BLOCK
                   ) -> torch.Tensor:
    """(N/B, B, B): the inverse of each (B, B) diagonal block of the
    lower-triangular L (N, N); N must be a multiple of B.

    CUDA kernel: ``csrc/tri_inv.cu`` tri_inv_panel_launch, replacing
    limbo_tpu/ops/chol.py:_tri_inv_panel, one grid over all diagonal blocks,
    reading only their lower triangles; the upper triangles of the output
    are exactly 0.0.  Bound on the H100 by the latency of its dependent
    steps (32-wide diagonal sub-inverses, then merges)."""
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


def cholesky_blocked(A: torch.Tensor, block: int = PANEL_BLOCK
                     ) -> torch.Tensor:
    """Lower Cholesky factor by left-looking blocked elimination
    (limbo_tpu/ops/chol.py:300-334).  For block column k (width B):

        panel  = A[kB:, kB:kB+B] - L[kB:, :kB] @ L[kB:kB+B, :kB]^T
        L11, L11^{-T} = panel factor of panel[:B]
        L21    = panel[B:] @ L11^{-T}

    A is assumed symmetric positive definite (padded-identity blocks are
    fine); an indefinite pivot leaves NaN from its block on."""
    A, n = _pad_identity(A, block)
    N = A.shape[0]
    L = torch.zeros((N, N), dtype=A.dtype, device=A.device)
    for k in range(N // block):
        j0, j1 = k * block, (k + 1) * block
        panel = A[j0:, j0:j1]                                   # (N-j0, B)
        if k > 0:
            panel = panel - L[j0:, :j0] @ L[j0:j1, :j0].T
        L11, L11invT = _panel_factor_pallas(panel[:block])
        L[j0:j1, j0:j1] = L11
        if j1 < N:
            L[j1:, j0:j1] = panel[block:] @ L11invT
    return L[:n, :n]


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


def use_blocked(n: int, device, dtype, min_blocked=None) -> bool:
    """The blocked factorization runs on the card in f32 from BLOCKED_MIN_N
    up, and wherever ``min_blocked`` (an explicit size floor) says so."""
    if min_blocked is not None:
        return n >= min_blocked
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and n >= BLOCKED_MIN_N)


def _cholesky_impl(A: torch.Tensor, block: int, min_blocked) -> torch.Tensor:
    if use_blocked(A.shape[0], A.device, A.dtype, min_blocked):
        return cholesky_blocked(A, block=block).contiguous()
    return _stock_cholesky(A)


class _Cholesky(torch.autograd.Function):
    """The reference's Cholesky pullback (limbo_tpu/ops/chol.py:428-437):

        P = L^T Lbar,  phi = tril(P) - diag(P) / 2,
        S = L^{-T} phi L^{-1},  Abar = (S + S^T) / 2,

    with L^{-1} from ``tri_inv`` (the tri-inv panel kernel on the card from
    TRI_INV_MIN_N) and every product in exact f32."""

    @staticmethod
    def forward(ctx, A, block, min_blocked):
        L = _cholesky_impl(A, block, min_blocked)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        P = L.T @ Lbar
        phi = torch.tril(P)
        phi.diagonal().mul_(0.5)
        del P
        Linv = tri_inv(L)
        S = (Linv.T @ phi) @ Linv
        del phi, Linv
        return 0.5 * (S + S.T), None, None


def cholesky(A: torch.Tensor, block: int = PANEL_BLOCK,
             min_blocked=None) -> torch.Tensor:
    """Lower Cholesky factor with the reference's size dispatch (see the
    module docstring); NaN where A is not positive definite.
    Differentiable through the reference's pullback."""
    return _Cholesky.apply(A, block, min_blocked)


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
