"""Closed forms of the flops one Ehvi iteration needs, in the conventions
of counts/flops.py: a multiply-add counts 2; "needed" is what the
mathematics asks at the valid sizes (no padded row of the front, no
product taken twice); elementwise work is not counted, except the EHVI's
products over its boxes, which are its arithmetic.

The configuration's objectives share one kernel and one set of inputs, so
one covariance, one Cholesky factor and one L^-1 k serve all p of them;
each objective has its own alpha and mean.  With n valid points in d
dimensions, a front of k points (the ascent's seeds) and ``steps`` Rprop
steps:

* ``refit(n, d, p)``: the training covariance's distances (``gram_train``),
  the Cholesky factor, and alpha for each objective (two triangular solves
  of one right-hand side).
* ``query(q, n, d, p)``: a posterior of q points: the distances (q n d
  MACs), v = L^-1 k^T (``tri_solve(n, q)``), the variance |v|^2 (q n) and
  each objective's mean k alpha (q n).
* ``query_grad(q, n, d, p)``: its backward: L^-T of the variance's gradient
  (``tri_solve(n, q)``), each mean's gradient alpha g (q n) and the
  distances' (q n d).
* ``ehvi(q, k, p)``: the box sum over (k + 1)^(p - 1) boxes, p - 1
  multiplies of the per-objective factors and one add a box;
  ``ehvi_grad`` the products' backward, 2 (p - 1) multiplies a box.
* ``iteration``: the refit, then ``steps`` ascent steps (query, EHVI and
  both backwards) and the last iterate's query and EHVI, over the k seeds.
  The front's dominance test is comparisons and is not counted.
"""

from __future__ import annotations

from perfbench.counts import flops


def refit(n: int, d: int, p: int) -> int:
    return flops.gram_train(n, d) + flops.cholesky(n) + p * flops.tri_solve(
        n, 2)


def query(q: int, n: int, d: int, p: int) -> int:
    return 2 * q * n * d + flops.tri_solve(n, q) + 2 * q * n * (1 + p)


def query_grad(q: int, n: int, d: int, p: int) -> int:
    return flops.tri_solve(n, q) + 2 * q * n * p + 2 * q * n * d


def ehvi(q: int, k: int, p: int) -> int:
    return q * (k + 1) ** (p - 1) * p


def ehvi_grad(q: int, k: int, p: int) -> int:
    return q * (k + 1) ** (p - 1) * 2 * (p - 1)


def iteration(n: int, d: int, p: int, k: int, steps: int) -> int:
    """The needed flops of one iteration at n valid points and a front of
    k points."""
    fwd = query(k, n, d, p) + ehvi(k, k, p)
    bwd = query_grad(k, n, d, p) + ehvi_grad(k, k, p)
    return refit(n, d, p) + steps * (fwd + bwd) + fwd
