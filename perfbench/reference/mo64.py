"""The plain reference of the multi-objective cell: DTLZ2, one exact GP per
objective with the Matern-5/2 kernel, the non-dominated set and the exact
3-objective EHVI, in float64, from the inputs the benchmark generated.

Plain PyTorch: nothing of the program, no kernel, no padding, no box
decomposition of the program's kind.

* ``dtlz2``: DTLZ2 with 3 objectives (Deb, Thiele, Laumanns & Zitzler,
  "Scalable multi-objective optimization test problems", CEC 2002) on
  [0, 1]^d, maximized as -f: g = sum_{i >= 2} (x_i - 1/2)^2 and
  f = (1 + g) (cos a cos b, cos a sin b, sin a), a = pi x_0 / 2,
  b = pi x_1 / 2.
* ``cov``: sf2 (1 + t + t^2 / 3) exp(-t), t = sqrt(5) |a - b| / l (limbo's
  matern_five_halves.hpp), the distances from ``torch.cdist`` without the
  expanded product form.
* ``GP``: the training covariance with noise + jitter max(sf2, 1) on its
  diagonal (the jitter the program's precision adds), factored once;
  ``posterior`` reads it over the first m rows (a BO run's earlier state):
  forward substitution over a leading block reads only that block, so
  v = L[:m, :m]^-1 [k, y_m] gives mean v_k^T v_y and variance
  sf2 - |v_k|^2.  Every objective shares the kernel, so one factor serves
  all of them.
* ``non_dominated``: every pair compared (maximization: j dominates i when
  it is >= in every objective and > in one).
* ``ehvi3``: the exact EHVI by the full grid: each axis cut at every front
  point's coordinate (clipped to the reference point) into k + 1 cells,
  each of the (k + 1)^3 cells tested directly against every front point
  (it is dominated when some point is at or below its lower corner in every
  objective, minimizing), and over the cells that are not, the product of
  the per-axis integrals E[(u - max(y, l))^+] of the candidate's
  independent Gaussians.  Computed in blocks of cells.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
BLOCK = 16          # grid slices along the first axis tested at once


def dtlz2(X: torch.Tensor) -> torch.Tensor:
    """(n, 3) objectives, maximized, of (n, d) inputs, in X's dtype."""
    g = (X[:, 2:] - 0.5).square().sum(1)
    a, b = 0.5 * math.pi * X[:, 0], 0.5 * math.pi * X[:, 1]
    r = 1.0 + g
    return -torch.stack([r * torch.cos(a) * torch.cos(b),
                         r * torch.cos(a) * torch.sin(b),
                         r * torch.sin(a)], dim=1)


def cov(A: torch.Tensor, B: torch.Tensor, ell: float, sf2: float
        ) -> torch.Tensor:
    """Matern-5/2 covariance of two sets of points, in their dtype."""
    r = torch.cdist(A, B, compute_mode="donot_use_mm_for_euclid_dist")
    t = r.mul_(math.sqrt(5.0) / ell)
    return (1.0 + t + t * t / 3.0) * torch.exp(-t) * sf2


class GP:
    """Exact GP regression of every column of Y on X, NullMean."""

    def __init__(self, X, Y, ell: float, sf2: float, noise: float,
                 jitter: float):
        self.X, self.Y = X.to(F64), Y.to(F64)
        self.ell, self.sf2 = ell, sf2
        K = cov(self.X, self.X, ell, sf2)
        K.diagonal().add_(noise + jitter * max(sf2, 1.0))
        self.L = torch.linalg.cholesky(K)

    def posterior(self, Q: torch.Tensor, m: int):
        """(mean (q, p), variance (q,)) at Q over the first m rows."""
        Q = Q.to(F64)
        k = cov(self.X[:m], Q, self.ell, self.sf2)
        V = torch.linalg.solve_triangular(
            self.L[:m, :m], torch.cat([k, self.Y[:m]], dim=1), upper=False)
        q = Q.shape[0]
        return V[:, :q].T @ V[:, q:], self.sf2 - V[:, :q].square().sum(0)


def non_dominated(Y: torch.Tensor, rows: int = 1024) -> torch.Tensor:
    """(n,) bool: no other row dominates the row (maximization)."""
    out = torch.empty(Y.shape[0], dtype=torch.bool, device=Y.device)
    for r0 in range(0, Y.shape[0], rows):
        y = Y[r0:r0 + rows, None, :]
        dom = ((Y[None] >= y).all(-1) & (Y[None] > y).any(-1)).any(1)
        out[r0:r0 + rows] = ~dom
    return out


def _Phi(z):
    return 0.5 * torch.special.erfc(-z / math.sqrt(2.0))


def _phi(z):
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def interval(lo, hi, mu, s):
    """E[(hi - max(y, lo))^+] for y ~ N(mu, s^2) and hi >= lo; lo may be
    -inf.  P(y < lo) (hi - lo) + E[(hi - y) 1{lo <= y < hi}]."""
    zh = (hi - mu) / s
    below = torch.isinf(lo)
    zl = torch.where(below, torch.zeros_like(zh), (lo - mu) / s)
    Pl = torch.where(below, torch.zeros_like(zh), _Phi(zl))
    pl = torch.where(below, torch.zeros_like(zh), _phi(zl))
    width = torch.where(below, torch.zeros_like(zh), hi - lo)
    return width * Pl + (hi - mu) * (_Phi(zh) - Pl) + s * (_phi(zh) - pl)


def grid(front: torch.Tensor, ref: torch.Tensor):
    """Cells of the minimization front below ref: per axis the lower and
    upper cell bounds ((k + 1,) each) and the (k + 1)^3 non-dominated
    mask."""
    f = torch.minimum(front.to(F64), ref)
    k = f.shape[0]
    inf = torch.full((1,), -math.inf, dtype=F64, device=f.device)
    edges = [torch.cat([inf, torch.sort(f[:, j]).values, ref[j:j + 1]])
             for j in range(3)]
    lo = [e[:-1] for e in edges]
    hi = [e[1:] for e in edges]
    at = [f[None, :, j] <= lo[j][:, None] for j in range(3)]   # (k+1, k)
    nd = torch.empty((k + 1,) * 3, dtype=torch.bool, device=f.device)
    for a0 in range(0, k + 1, BLOCK):
        dom = (at[0][a0:a0 + BLOCK, None, None, :]
               & at[1][None, :, None, :]
               & at[2][None, None, :, :]).any(-1)
        nd[a0:a0 + BLOCK] = ~dom
    return lo, hi, nd


def ehvi3(mu: torch.Tensor, sigma: torch.Tensor, front: torch.Tensor,
          ref) -> torch.Tensor:
    """Exact EHVI (maximization) of candidates with independent Gaussian
    objectives mu, sigma (q, 3) over the front (k, 3) and the reference
    point (3,); returns (q,)."""
    mu, sigma = mu.to(F64), sigma.to(F64)
    r = -torch.as_tensor(ref, dtype=F64, device=mu.device)
    lo, hi, nd = grid(-front.to(F64), r)
    F = [interval(lo[j][None], hi[j][None], -mu[:, j:j + 1],
                  sigma[:, j:j + 1]) for j in range(3)]         # (q, k+1)
    w = torch.einsum("abc,qc->qab", nd.to(F64), F[2])
    return torch.einsum("qab,qa,qb->q", w, F[0], F[1])
