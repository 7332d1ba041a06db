"""Closed forms of the operations and bytes the benchmark's work needs.

A flop is one floating-point multiply or add; a multiply-add counts 2.
"Needed" means what the mathematics asks at the valid sizes: no padded
rows, no structural zeros of a triangle, no product taken twice.  Square
roots, divisions, exponentials and the other elementwise work are not
counted (they are O(n) or O(q n) beside the products that are counted).

The peaks are NVIDIA's data-sheet rates of one H100 SXM at 700 W.

Derivations (m MACs = 2 m flops):

* ``cholesky(n)``: column j takes j MACs for its diagonal and j for each of
  the n - j - 1 entries below it: sum_j j (n - j) = (n^3 - n) / 6 MACs.
* ``tri_inv(n)``: column c of L^-1 is zero above c; its entry i > c takes
  i - c MACs: sum_c (n-c-1)(n-c)/2 = (n^3 - n) / 6 MACs.
* ``tri_gram(n)``: the lower half (i >= j) of V^T V for lower V: entry
  (i, j) sums rows k >= i, n - i MACs, for i + 1 values of j:
  sum_i (i + 1)(n - i) = n (n + 1)(n + 2) / 6 MACs.
* ``trimv(n)``: row i of a lower triangle takes i + 1 MACs: n (n + 1) / 2.
* ``tri_solve(n, k)``: forward substitution, row i takes i MACs per
  right-hand side: k n (n - 1) / 2.
* ``gram(q, n, d)``: the distances' product, q n d MACs;
  ``gram_train(n, d)`` its lower half with the diagonal, n (n + 1) d / 2.
* ``query(q, n, d, p)``: a cached posterior of q points over n data with p
  pending pivots: the distances (q n d), the mean ks alpha (q n), the
  mirror product ks M (q n^2) and the pending correction (ks P) P^T
  (2 q n p) MACs.  ``query_grad`` is its backward: the distances' product
  again (q n d) and the mean's (q n); the variance's backward reuses the
  forward's product (2 g t), as the program's does, and needs none.
* ``bo_iteration``: the sweep's query, ``steps`` ascent steps (a query
  and its backward each) and the last iterate's query over ``restarts``
  points, then the append: k = k(x, X) (n d), two triangle matvecs.  A
  flush adds, for the f32 master, P P^T (m n^2) and K^-1 [y 1] (2 n^2);
  for the lite cache the mirror from Linv (``tri_gram``) and two passes
  over Linv for [y 1] (2 x 2 ``trimv``).
* ``lml(n, d)``: the training covariance, the Cholesky and the two
  triangular solves of alpha; ``lml_grad`` adds L^-1, K^-1 = L^-T L^-1
  (``tri_gram``) and the contraction of (alpha alpha^T - K^-1) with each
  of the d + 1 covariance derivatives (n^2 MACs each).
* ``refit(n, d)``: ``lml`` (the fit) and the lite build: L^-1, the mirror
  (``tri_gram``) and two passes over Linv for [y 1].
* ``mirror_mm_bytes(q, K, N)``: the bf16 mirror (2 K N), ks in f32
  (4 q K) and the f32 result (4 q N), each once; its operations 2 q K N.
"""

from __future__ import annotations

PEAK_BF16 = 989e12      # dense bf16 on the tensor cores
PEAK_TF32 = 495e12      # dense TF32: the fastest rate for f32 operands
PEAK_F32 = 67e12        # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def cholesky(n: int) -> int:
    return 2 * (n ** 3 - n) // 6


def tri_inv(n: int) -> int:
    return 2 * (n ** 3 - n) // 6


def tri_gram(n: int) -> int:
    return 2 * n * (n + 1) * (n + 2) // 6


def trimv(n: int) -> int:
    return n * (n + 1)


def tri_solve(n: int, k: int = 1) -> int:
    return k * n * (n - 1)


def gram(q: int, n: int, d: int) -> int:
    return 2 * q * n * d


def gram_train(n: int, d: int) -> int:
    return n * (n + 1) * d


def query(q: int, n: int, d: int, p: int = 0) -> int:
    return 2 * q * n * (d + 1 + n + 2 * p)


def query_grad(q: int, n: int, d: int) -> int:
    return 2 * q * n * (d + 1)


def append(n: int, d: int) -> int:
    return 2 * n * d + 2 * trimv(n)


def flush(n: int, m: int, lite: bool) -> int:
    if lite:
        return tri_gram(n) + 4 * trimv(n)
    return 2 * m * n * n + 2 * 2 * n * n


def bo_iteration(n: int, d: int, restarts: int, steps: int, sweep: int,
                 pending: int, flushes: bool = False, m: int = 0,
                 lite: bool = False) -> int:
    """The needed flops of one BO iteration at n valid points with
    ``pending`` pivots pending before its append."""
    f = query(sweep, n, d, pending)
    f += steps * (query(restarts, n, d, pending) + query_grad(restarts, n, d))
    f += query(restarts, n, d, pending)
    f += append(n, d)
    if flushes:
        f += flush(n + 1, m, lite)
    return f


def lml(n: int, d: int) -> int:
    return gram_train(n, d) + cholesky(n) + tri_solve(n, 2)


def lml_grad(n: int, d: int) -> int:
    return lml(n, d) + tri_inv(n) + tri_gram(n) + 2 * (d + 1) * n * n


def refit(n: int, d: int) -> int:
    return lml(n, d) + tri_inv(n) + tri_gram(n) + 4 * trimv(n)


def mirror_mm_bytes(q: int, K: int, N: int) -> int:
    return 2 * K * N + 4 * q * K + 4 * q * N


def mirror_mm_ops(q: int, K: int, N: int) -> int:
    return 2 * q * K * N


def bound_s(nbytes: float, ops: float, peak_ops: float) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_ops)
