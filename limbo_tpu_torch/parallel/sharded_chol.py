"""Row-sharded blocked Cholesky + exact GP fit / query over the mesh (port
of limbo_tpu/parallel/sharded_chol.py).

The distributed factorization: an exact lower Cholesky factor of the
n x n training covariance with its rows split over the ranks, giving exact
log-determinants (so the exact LML) and exact posterior variances past one
card's memory.  The reference's counterpart is the single-host LLT inside
GP::compute (limbo model/gp.hpp:550-605).

Left-looking blocked Cholesky on a block-ROW split, block column k (width
B) at a time:

    Lrow_k = rows [kB, kB+B) of L, columns [:kB)      (owner -> psum)
    panel  = A[:, kB:kB+B] - L[:, :kB] @ Lrow_k^T     (local GEMM, own rows)
    D      = rows [kB, kB+B) of panel                 (owner -> psum)
    L11, L11inv = panel factor of D                   (replicated, B x B)
    L[:, kB:kB+B] = panel @ L11inv^T                  (local GEMM)

Every O(n^3) operation is a local GEMM over a rank's own rows; the only
communication a step is a psum of a (B, kB) strip and of a (B, B) block.
The diagonal block D is factored and inverted by the panel-factor kernel
(``csrc/panel_factor.cu`` through ``ops/chol.panel_factor``), which exists
for B = PANEL_BLOCK only and raises on the card for any other block.

Where the reference computes all local rows at every step and masks those
above the block column (static shapes for XLA), the loops here touch only
the local rows at or below it: eager PyTorch slices freely, the rows left
out are the masked ones, and the rank that owns the last rows, which sets
the pace at every psum, does the same work either way.  The loops are
unrolled on the host: N / B steps, each a few launches and a collective.

Triangular solves against the sharded factor use the same two primitives:
a forward right-looking substitution (each step one (rows, B) x (B, q)
GEMM on the rank's rows and a (B, q) psum) and a backward left-looking one
(the transpose product is distributed because L^T's columns are L's rows,
the split axis).

Sharded state (``ShardedGP.L``) is the rank's (N / D, N) row block; the
rest is replicated.  Every function takes the replicated inputs and slices
its own rows, row0 = rank * N / D.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from limbo_tpu_torch.means.means import prepare_mean
from limbo_tpu_torch.ops.chol import PANEL_BLOCK, panel_factor
from limbo_tpu_torch.parallel.mesh import Axis, mesh_axis, psum
from limbo_tpu_torch.utils.precision import exact

# The reference's B = 256 was a TPU choice: one f32 block is 256 KiB there,
# above the 227 KB of shared memory a Hopper block may use.  The port's
# panel kernels keep two B x B f32 buffers resident (and the tri-inv kernel
# half of a third), 128 KB and more at B = 128, and are compiled for this
# block only.
DEFAULT_BLOCK = PANEL_BLOCK


def _geometry(mesh, axis, N: int, block: int):
    """(Axis, ranks, rows a rank) of an N-row split; N must be a multiple
    of ranks * block."""
    ax = mesh_axis(mesh, axis)
    if N % (ax.size * block) != 0:
        raise ValueError(
            f"N={N} must be a multiple of n_devices*block = "
            f"{ax.size * block} (pad the capacity; identity-padded blocks "
            f"factor exactly)")
    return ax, ax.size, N // ax.size


def _first_at(j: int, row0: int, rows_loc: int) -> int:
    """The first local row whose global index is at least j."""
    return min(max(j - row0, 0), rows_loc)


def _owner_extract(M_loc: torch.Tensor, row0: int, rows_loc: int, j0: int,
                   width: int, ncols: int, ax: Axis) -> torch.Tensor:
    """Rows [j0, j0 + width), columns [:ncols), of the global row-split
    matrix whose local rows M_loc start at global row row0: the owner
    contributes its slice, every other rank zeros, and a psum hands the
    block to all."""
    if row0 <= j0 and j0 + width <= row0 + rows_loc:
        i = j0 - row0
        buf = M_loc[i:i + width, :ncols].clone()
    else:
        buf = torch.zeros((width, ncols), dtype=M_loc.dtype,
                          device=M_loc.device)
    return psum(buf, ax)


@dataclass
class ShardedGP:
    """Exact GP state with the Cholesky factor's rows split over the mesh.

    L is this rank's (N / D, N) row block of the factor (rows row0 =
    rank * N / D on); everything else is replicated: L11invs (nb, B, B),
    the inverses of the diagonal blocks, alpha (N, p) = K^{-1}(y - m), and
    the scalars.  n is the true sample count (Python int)."""

    kernel: object
    mean: object
    x: torch.Tensor
    y: torch.Tensor
    n: int
    L: torch.Tensor
    L11invs: torch.Tensor
    alpha: torch.Tensor
    logdet: torch.Tensor
    lml: torch.Tensor
    block: int = DEFAULT_BLOCK
    axis: Optional[Axis] = None

    replace = dataclasses.replace

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dim_in(self) -> int:
        return self.x.shape[1]

    @property
    def dim_out(self) -> int:
        return self.y.shape[1]

    @property
    def mask(self) -> torch.Tensor:
        return (torch.arange(self.capacity, device=self.x.device)
                < self.n).to(self.x.dtype)


def _factor_loop(A_loc: torch.Tensor, c: torch.Tensor, row0: int,
                 rows_loc: int, N: int, block: int, ax: Axis):
    """Factor the row-split A (this rank's rows A_loc) and solve K a = c
    (c (N, p) replicated).  Returns (L_loc, L11invs, a, logdet)."""
    nb = N // block
    kw = dict(dtype=A_loc.dtype, device=A_loc.device)
    L_loc = torch.zeros((rows_loc, N), **kw)
    L11invs = torch.empty((nb, block, block), **kw)
    # the factor's GEMMs are exact in both modes (the reference pins them
    # at HIGHEST, sharded_chol.py:153,159); the solve below is not
    with exact():
        for k in range(nb):
            j0, j1 = k * block, (k + 1) * block
            lo = _first_at(j0, row0, rows_loc)
            if k > 0:
                Lrow_k = _owner_extract(L_loc, row0, rows_loc, j0, block, j0,
                                        ax)                          # (B, kB)
                panel = A_loc[lo:, j0:j1] - L_loc[lo:, :j0] @ Lrow_k.T
            else:
                panel = A_loc[lo:, j0:j1]
            D = _owner_extract(panel, row0 + lo, rows_loc - lo, j0, block,
                               block, ax)
            L11, L11invs[k] = panel_factor(D)
            L_loc[lo:, j0:j1] = panel @ L11invs[k].T
            if row0 <= j0 < row0 + rows_loc:
                L_loc[lo:lo + block, j0:j1] = L11         # the exact triangle
    a = _dist_cho_solve(L_loc, L11invs, c, row0, rows_loc, N, block, ax)
    diag = torch.diagonal(L_loc[:, row0:row0 + rows_loc])
    logdet = 2.0 * psum(torch.sum(torch.log(diag)).reshape(1), ax)[0]
    return L_loc, L11invs, a, logdet


def _forward_solve(L_loc, L11invs, C_loc, row0: int, rows_loc: int, N: int,
                   block: int, ax: Axis) -> torch.Tensor:
    """w = L^{-1} C (N, q), replicated, against the row-split factor, from
    this rank's rows C_loc of C; right-looking: w_k from the owner's
    residual rows (a (B, q) psum), then one (rows, B) x (B, q) GEMM pushes
    it into this rank's rows below the block (rows above it are never read
    again).  C_loc is overwritten."""
    r_loc = C_loc
    w = torch.zeros((N, C_loc.shape[1]), dtype=C_loc.dtype,
                    device=C_loc.device)
    for k in range(N // block):
        j0, j1 = k * block, (k + 1) * block
        rk = _owner_extract(r_loc, row0, rows_loc, j0, block,
                            C_loc.shape[1], ax)
        w[j0:j1] = L11invs[k] @ rk
        hi = _first_at(j1, row0, rows_loc)
        r_loc[hi:] -= L_loc[hi:, j0:j1] @ w[j0:j1]
    return w


def _backward_solve(L_loc, L11invs, w, row0: int, rows_loc: int, N: int,
                    block: int, ax: Axis) -> torch.Tensor:
    """a = L^{-T} w (w (N, q) replicated), left-looking over the block rows
    of L^T, i.e. the block columns of L, whose tails are row-split: each
    step a psum of (tail rows)^T a (tail rows), (B, q)."""
    a = torch.zeros_like(w)
    for k in reversed(range(N // block)):
        j0, j1 = k * block, (k + 1) * block
        hi = _first_at(j1, row0, rows_loc)
        s = psum(L_loc[hi:, j0:j1].T @ a[row0 + hi:row0 + rows_loc], ax)
        a[j0:j1] = L11invs[k].T @ (w[j0:j1] - s)
    return a


def _dist_cho_solve(L_loc, L11invs, C, row0: int, rows_loc: int, N: int,
                    block: int, ax: Axis) -> torch.Tensor:
    """a = K^{-1} C against the row-split factor (C (N, q) replicated):
    forward then backward substitution, per step one local GEMM and one
    (B, q) psum."""
    w = _forward_solve(L_loc, L11invs, C[row0:row0 + rows_loc].clone(),
                       row0, rows_loc, N, block, ax)
    return _backward_solve(L_loc, L11invs, w, row0, rows_loc, N, block, ax)


def sharded_cholesky(mesh, A: torch.Tensor, block: int = DEFAULT_BLOCK,
                     axis: Optional[str] = None) -> torch.Tensor:
    """This rank's (N / D, N) row block of the lower Cholesky factor of the
    positive-definite A (N, N), replicated, factored with its rows split
    over the mesh."""
    N = A.shape[0]
    ax, _, rows_loc = _geometry(mesh, axis, N, block)
    row0 = ax.rank * rows_loc
    L_loc, _, _, _ = _factor_loop(
        A[row0:row0 + rows_loc], torch.zeros((N, 1), dtype=A.dtype,
                                             device=A.device),
        row0, rows_loc, N, block, ax)
    return L_loc


def _local_gram(kernel, X: torch.Tensor, mask: torch.Tensor, row0: int,
                rows_loc: int) -> torch.Tensor:
    """This rank's rows of the Cholesky-ready padded training covariance:
    gram rows with identity padding on masked rows and columns (as
    utils.maths.masked_identity_gram), built in place (no other N-wide
    temporary)."""
    x_loc = X[row0:row0 + rows_loc]
    m_loc = mask[row0:row0 + rows_loc]
    G = kernel.gram(x_loc, X)
    G.mul_(m_loc[:, None]).mul_(mask[None, :])
    diag_val = m_loc * kernel.train_diag_add(x_loc) + (1.0 - m_loc)
    torch.diagonal(G[:, row0:row0 + rows_loc]).add_(diag_val)
    return G


def sharded_fit(mesh, kernel, mean, X: torch.Tensor, Y: torch.Tensor,
                n: Optional[int] = None, block: int = DEFAULT_BLOCK,
                axis: Optional[str] = None) -> ShardedGP:
    """Exact GP fit with the covariance factored across the mesh.

    X: (N, d), Y: (N, p), replicated, padded to a multiple of
    n_devices * block; `n` is the true sample count (default N).  Each
    rank builds its own gram rows (never all of K), identity-padded,
    factors them with the sharded blocked Cholesky and solves for alpha;
    the exact LML comes out of the same pass.  Functional parity: limbo
    GP::compute + compute_log_lik (model/gp.hpp:88,267) at mesh scale."""
    X = torch.atleast_2d(X)
    Y = torch.atleast_2d(Y).to(X.dtype)
    N = X.shape[0]
    ax, _, rows_loc = _geometry(mesh, axis, N, block)
    n = N if n is None else int(n)
    mask = (torch.arange(N, device=X.device) < n).to(X.dtype)
    mean = prepare_mean(mean, Y, mask)
    centered = (Y - mean(X)) * mask[:, None]
    row0 = ax.rank * rows_loc
    G = _local_gram(kernel, X, mask, row0, rows_loc)
    L_loc, L11invs, alpha, logdet = _factor_loop(G, centered, row0,
                                                 rows_loc, N, block, ax)
    del G
    lml = (-0.5 * torch.sum(centered * alpha) - 0.5 * logdet
           - 0.5 * n * math.log(2.0 * math.pi))
    return ShardedGP(kernel=kernel, mean=mean, x=X, y=Y, n=n, L=L_loc,
                     L11invs=L11invs, alpha=alpha, logdet=logdet, lml=lml,
                     block=block, axis=ax)


def sharded_query(mesh, sgp: ShardedGP, Xq: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact posterior (mu, sigma^2) of a candidate batch against the
    sharded factor.

    mu is a psum of the row-split cross-covariance products; sigma^2 =
    k_diag - |L^{-1} k_q|^2 by the distributed right-looking forward
    solve.  Parity: limbo GP::query
    (model/gp.hpp:159-167,613-626)."""
    N, block = sgp.capacity, sgp.block
    ax, _, rows_loc = _geometry(mesh, sgp.axis, N, block)
    row0 = ax.rank * rows_loc
    kernel = sgp.kernel
    Xq = torch.atleast_2d(Xq).to(sgp.x.dtype)
    m_loc = sgp.mask[row0:row0 + rows_loc]
    Kq_loc = kernel.gram(sgp.x[row0:row0 + rows_loc], Xq) * m_loc[:, None]
    mu = psum(Kq_loc.T @ sgp.alpha[row0:row0 + rows_loc], ax)
    w = _forward_solve(sgp.L, sgp.L11invs, Kq_loc, row0, rows_loc, N,
                       block, ax)
    ssq = torch.sum(w * w, dim=0)
    var = torch.clamp(kernel.k_diag(Xq) - ssq, min=0.0)
    return mu + sgp.mean(Xq), var
