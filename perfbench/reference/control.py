"""The controls: the reference computed one precision below what the
configuration states, put in the program's place.  A control must come out
not correct; the readings it gives set the upper end of each limit.

* TF32 for the configuration's float32 (with TF32 off): every product takes
  its operands rounded to TF32 (10 explicit mantissa bits, to nearest) and
  sums in float32, as the tensor cores' TF32 mode does.  The rounding is
  done here, in plain PyTorch, so the control reads the same on a CPU and
  on the card, whatever the process's matmul mode.  The covariance is the
  reference's (direct differences, no product) in float32.  The
  factorizations are blocked (256 wide; tests at small sizes pass a
  narrower block): each diagonal block in float32, every product between
  blocks in TF32.
* float8 (e4m3, scaled so the largest entry maps to 448) for the
  configuration's bfloat16 K^-1 mirror.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import gp64

F32 = torch.float32
BLOCK = 256
FP8_MAX = 448.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32: the 13 low mantissa bits dropped, to
    nearest, ties to even."""
    i = x.contiguous().view(torch.int32)
    bias = ((i >> 13) & 1) + 0x0FFF
    return ((i + bias) & -8192).view(F32)


def mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B with TF32 operands and f32 sums."""
    return tf32(A) @ tf32(B)


def fp8(M: torch.Tensor) -> torch.Tensor:
    """M rounded through float8 e4m3 with one scale for the tensor, back
    in M's dtype."""
    s = FP8_MAX / float(M.abs().max())
    return (M * s).to(torch.float8_e4m3fn).to(M.dtype) / s


def cholesky(K: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """Right-looking blocked Cholesky of an f32 matrix, the products
    between blocks in TF32."""
    block = block or BLOCK
    A = K.to(F32).clone()
    n = A.shape[0]
    for k in range(0, n, block):
        e = min(k + block, n)
        A[k:e, k:e] = torch.linalg.cholesky(A[k:e, k:e])
        if e < n:
            inv = torch.linalg.solve_triangular(
                A[k:e, k:e], torch.eye(e - k, dtype=F32, device=A.device),
                upper=False)
            A[e:, k:e] = mm(A[e:, k:e], inv.T)
            A[e:, e:] -= mm(A[e:, k:e], A[e:, k:e].T)
    return torch.tril(A)


def tri_inv(L: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """L^-1 of a lower f32 factor, block row by block row: each diagonal
    block inverted in f32, the rest of a block row by TF32 products."""
    block = block or BLOCK
    n = L.shape[0]
    V = torch.zeros_like(L)
    for k in range(0, n, block):
        e = min(k + block, n)
        d = torch.linalg.solve_triangular(
            L[k:e, k:e], torch.eye(e - k, dtype=F32, device=L.device),
            upper=False)
        V[k:e, k:e] = d
        if k:
            V[k:e, :k] = -mm(d, mm(L[k:e, :k], V[:k, :k]))
    return V


class State:
    """The reference's L, Linv, Kinv and alpha computed in TF32 from the
    f32 covariance of the same data."""

    def __init__(self, X, Y, theta, noise: float, block: int | None = None):
        theta = torch.as_tensor(theta, dtype=torch.float64).cpu()
        d = X.shape[1]
        self.sf2 = math.exp(2.0 * float(theta[d]))
        Xs = gp64.scaled(X, theta[:d]).to(F32)
        K = gp64.cov(Xs, Xs, self.sf2)
        K.diagonal().add_(gp64.diag_add(noise, self.sf2))
        Y = Y.to(torch.float64).reshape(-1, 1)
        self.r = (Y - Y.mean()).to(F32)
        self.L = cholesky(K, block)
        del K
        self.Linv = tri_inv(self.L, block)
        self.Kinv = mm(self.Linv.T, self.Linv)
        self.alpha = mm(self.Kinv, self.r)


def lml_grad(X, Y, theta, noise: float, rows: int = 1024,
             block: int | None = None):
    """(value, grad) of the LML at theta from the TF32 state: the value
    from its factor and alpha, the gradient 1/2 sum (alpha alpha^T -
    K^-1) o dK in f32."""
    theta = torch.as_tensor(theta, dtype=torch.float64).cpu()
    d = X.shape[1]
    s = State(X, Y, theta, noise, block)
    n = s.L.shape[0]
    fit = -0.5 * float((s.r * s.alpha).sum())
    logdet = -float(torch.log(torch.diagonal(s.L)).sum())
    value = fit + logdet - 0.5 * n * math.log(2.0 * math.pi)
    Xs = gp64.scaled(X, theta[:d]).to(F32)
    a = s.alpha[:, 0]
    g = torch.zeros(d + 1, dtype=torch.float64)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        Ks = gp64.cov(Xs[r0:r1], Xs, s.sf2)
        W = (a[r0:r1, None] * a[None, :] - s.Kinv[r0:r1]) * Ks
        for j in range(d):
            D = (Xs[r0:r1, j, None] - Xs[None, :, j]).square_()
            g[j] += 0.5 * float((W * D).sum())
        g[d] += float(W.sum())
    if s.sf2 > 1.0:
        dd = 2.0 * gp64.JITTER * s.sf2
        g[d] += 0.5 * dd * float((a * a).sum() - torch.diagonal(s.Kinv).sum())
    return value, g
