"""Cached-K^{-1} BO at n beyond one card's memory (port of
limbo_tpu/parallel/sharded_big.py).

Composes the two sharded layers into one large-n BO path in which no
N x N buffer is ever whole on one rank:

  * fit: ``parallel.sharded_chol.sharded_fit``, the row-split blocked
    Cholesky (exact factor, LML, alpha);
  * cache build: K^{-1} column panels solved straight from the row-split
    factor (``sharded_cache_from_fit``): a panel is one distributed
    two-triangular solve with identity columns as right-hand sides, all
    ranks cooperating, its owner keeping the result;
  * iterate (``make_big_bo_iter``, or ``make_big_propose`` +
    ``make_big_add`` for host objectives): the column-split acquisition
    of ``parallel.sharded_acq`` and a distributed append, whose pivot
    u = K^{-1} k comes from the same distributed solves against the
    maintained factor, whose new Cholesky row is an owner-local write, and
    whose K^{-1} panels take the deferred rank-m flush locally.

Memory a rank: its rows of L (N^2 / D f32) and its K^{-1} panel (N^2 / D
in the mirror's dtype) plus O(N) vectors; the build's and the flush's
transients are bounded by the solve's strip width (3 N x strip words,
strip <= 2048).

The append and the build loop over the N / B blocks on the host, one
launch group and a collective a step (parallel/sharded_chol.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from limbo_tpu_torch.kernels.base import effective_jitter
from limbo_tpu_torch.means.means import (ConstantMean, DataMean, NullMean,
                                         prepare_mean)
from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.parallel.mesh import Axis
from limbo_tpu_torch.parallel.sharded_acq import (_acq_fn, _flush_panel,
                                                  _pending_correction,
                                                  _sharded_sym_quad)
from limbo_tpu_torch.parallel.sharded_chol import (DEFAULT_BLOCK,
                                                   ShardedGP,
                                                   _backward_solve,
                                                   _dist_cho_solve,
                                                   _forward_solve,
                                                   _owner_extract)
from limbo_tpu_torch.utils.precision import solve_triangular


@dataclass
class BigGP:
    """GP state for n past one card: the factor row-split (L, the rank's
    (N / D, N) rows), the K^{-1} query panels column-split (Kq, the rank's
    (N, N / D) columns, in the mirror's dtype), the rest replicated.

    Has the GP surface the acquisition layer reads (kernel, mean, x, y,
    n, mask, capacity, dims) and answers its queries through
    ``query_posterior`` (big_query: the column-split quadratic form and
    the pending-pivot window of the deferred update, always on here), so
    the acquisitions take it as they take a GP.  n and base_n are Python
    ints."""

    kernel: object
    mean: object
    x: torch.Tensor          # (N, d)
    y: torch.Tensor          # (N, p)
    n: int
    L: torch.Tensor          # (N / D, N) this rank's rows of the factor
    L11invs: torch.Tensor    # (nb, B, B) diagonal-block inverses
    alpha: torch.Tensor      # (N, p)
    Kq: torch.Tensor         # (N, N / D) this rank's columns of K^{-1}
    P: torch.Tensor          # (N, m) pending scaled pivots
    base_n: int              # n at the last flush
    ay: torch.Tensor         # (N, p) K^{-1} (y masked)
    u_ones: torch.Tensor     # (N,) K^{-1} mask
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
    def n_dev(self) -> torch.Tensor:
        return gp_mod._count(self.n, self.x.device)

    @property
    def mask(self) -> torch.Tensor:
        return (torch.arange(self.capacity, device=self.x.device)
                < self.n).to(self.x.dtype)

    def query_posterior(self, Xq: torch.Tensor):
        """Model-protocol hook read by models.dispatch.query_any."""
        return big_query(self, Xq)


def _build_panels(L_loc, L11invs, row0: int, rows_loc: int, N: int,
                  block: int, ax: Axis, nloc: int, qd, strip: int = 2048,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's (N, N / D) column panel of K^{-1}, solved from the
    row-split factor in column strips of width <= `strip`: the identity
    columns and the solve's temporaries are (N, strip), so the build's
    transient footprint is a small multiple of the strip instead of another
    panel.  Every rank takes part in every strip (the solve needs the whole
    factor); only the strip's owner keeps it.  ``out`` takes the panel in
    place."""
    w_s = gp_mod._panel_width(nloc, strip)
    Kq_loc = out if out is not None else torch.empty(
        (N, nloc), dtype=qd, device=L_loc.device)
    E = torch.zeros((N, w_s), dtype=L_loc.dtype, device=L_loc.device)
    for pnl in range(N // nloc):
        for s0 in range(0, nloc, w_s):
            c0 = pnl * nloc + s0
            E.zero_()
            torch.diagonal(E[c0:c0 + w_s]).fill_(1.0)
            a = _dist_cho_solve(L_loc, L11invs, E, row0, rows_loc, N, block,
                                ax)
            if ax.rank == pnl:
                Kq_loc[:, s0:s0 + w_s] = a
    return Kq_loc


def _rhs(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(y masked | mask): K^{-1} of it gives ay and u_ones."""
    return torch.cat([y * mask[:, None], mask[:, None]], dim=1)


def sharded_cache_from_fit(mesh, sgp: ShardedGP, qdtype=None,
                           defer_m: int = 64) -> BigGP:
    """The column-split K^{-1} panels (in ``qdtype``, default the GP's
    dtype) solved straight from the row-split factor, and ay / u_ones from
    one more distributed solve.  Communication over the build is 2 N^2 +
    2 N (p + 1) words a rank, the once-per-refresh price of never forming
    K^{-1} on one card."""
    ax = sgp.axis
    N, dtype = sgp.capacity, sgp.x.dtype
    rows_loc = nloc = N // ax.size
    row0 = ax.rank * rows_loc
    Kq = _build_panels(sgp.L, sgp.L11invs, row0, rows_loc, N, sgp.block, ax,
                       nloc, qdtype if qdtype is not None else dtype)
    av = _dist_cho_solve(sgp.L, sgp.L11invs, _rhs(sgp.y, sgp.mask), row0,
                         rows_loc, N, sgp.block, ax)
    return BigGP(kernel=sgp.kernel, mean=sgp.mean, x=sgp.x, y=sgp.y, n=sgp.n,
                 L=sgp.L, L11invs=sgp.L11invs, alpha=sgp.alpha, Kq=Kq,
                 P=torch.zeros((N, defer_m), dtype=dtype,
                               device=sgp.x.device),
                 base_n=sgp.n, ay=av[:, :-1], u_ones=av[:, -1],
                 block=sgp.block, axis=ax)


def big_query(big: BigGP, Xq: torch.Tensor):
    """Posterior (mu, var) through the column-split K^{-1} panels and the
    pending pivots (sharded_acq's quadratic form against BigGP state)."""
    Xq = torch.atleast_2d(torch.as_tensor(Xq, device=big.x.device)
                          ).to(big.x.dtype)
    ks = big.kernel.gram(Xq, big.x) * big.mask[None, :]
    mu = ks @ big.alpha + big.mean(Xq)
    idx = torch.arange(big.capacity, device=ks.device)
    pend = ((idx >= big.base_n) & (idx < big.n)).to(ks.dtype)
    quad = (_sharded_sym_quad(big.axis, ks, big.Kq)
            + _pending_correction(ks, big.P, pend))
    var = big.kernel.k_diag(Xq) - quad
    return mu, gp_mod._clamp0(var)


def _big_add(big: BigGP, x_new: torch.Tensor, y_new: torch.Tensor,
             ax: Axis) -> BigGP:
    """Distributed append: the pivot by two distributed triangular solves
    against the row-split factor, the new factor row written by its owner,
    the diagonal block holding it re-inverted, and the deferred rank-m
    panel flush.  The factor, x, y, L11invs, P and the panels are updated
    in place."""
    if not isinstance(big.mean, (NullMean, ConstantMean, DataMean)):
        raise ValueError("big appends support constant-type means only")
    N, block = big.capacity, big.block
    rows_loc = big.L.shape[0]
    row0 = ax.rank * rows_loc
    dtype = big.x.dtype
    i = big.n
    if i >= N:
        raise ValueError(f"GP is full (capacity {N})")
    mask = big.mask
    x_new = torch.as_tensor(x_new, dtype=dtype, device=big.x.device)
    y_new = torch.as_tensor(y_new, dtype=dtype, device=big.x.device)
    k_vec = big.kernel.gram(x_new[None, :], big.x)[0] * mask
    diag_add = big.kernel.train_diag_add(x_new[None, :])[0]
    kappa = big.kernel.k_diag(x_new[None, :])[0] + diag_add
    # noise-aware Schur floor (see gp.add_sample_cached)
    s_floor = torch.maximum(diag_add, effective_jitter(dtype) * kappa)
    e_i = gp_mod._onehot(N, big.n_dev, big.x)

    # --- pivot: l = L^{-1} k (forward), u = L^{-T} l (backward) ---------
    geo = (row0, rows_loc, N, block, ax)
    l = _forward_solve(big.L, big.L11invs,
                       k_vec[row0:row0 + rows_loc, None].clone(), *geo)
    u = _backward_solve(big.L, big.L11invs, l, *geo)[:, 0] * mask
    l = l[:, 0] * mask
    s = torch.clamp(kappa - torch.dot(k_vec, u), s_floor, kappa)
    d = torch.sqrt(s)
    v = u - e_i

    # --- the new factor row, written by its owner -----------------------
    if row0 <= i < row0 + rows_loc:
        big.L[i - row0] = l + d * e_i
    # --- the inverse of the diagonal block holding row i ----------------
    kb = i // block
    j0 = kb * block
    blk = _owner_extract(big.L[:, j0:], row0, rows_loc, j0, block, block, ax)
    big.L11invs[kb] = solve_triangular(
        blk, torch.eye(block, dtype=dtype, device=blk.device), upper=False)

    # --- O(N) bordered recurrences + deferred panel bookkeeping ----------
    big.x[i] = x_new
    big.y[i] = y_new
    n_new = i + 1
    mask2 = (torch.arange(N, device=big.x.device) < n_new).to(dtype)
    ym = big.y * mask2[:, None]
    count = i - big.base_n
    big.P[:, count] = v / d
    base_n = big.base_n
    if count + 1 >= big.P.shape[1]:
        rhs = _rhs(big.y, mask2)
        if big.Kq.dtype != dtype:
            # a low-precision panel cannot take the rank-m add in place
            # (the correction is below its rounding step and is absorbed,
            # as in the single-card lite cache): rebuild the rank's panel
            # exactly from the updated factor, and ay / u_ones by an exact
            # distributed solve.  This flush costs a cache build.
            _build_panels(big.L, big.L11invs, row0, rows_loc, N, block, ax,
                          big.Kq.shape[1], big.Kq.dtype, out=big.Kq)
            av = _dist_cho_solve(big.L, big.L11invs, rhs, *geo)
        else:
            idx = torch.arange(N, device=big.x.device)
            pend = ((idx >= big.base_n) & (idx <= i)).to(dtype)
            av = _flush_panel(big.Kq, big.P, pend, rhs, ax)
        big.P.zero_()
        base_n = n_new
        ay, u_ones = av[:, :-1], av[:, -1]
    else:
        ay = big.ay + v[:, None] * ((v @ ym) / s)[None, :]
        u_ones = big.u_ones + v * (torch.dot(v, mask2) / s)
    mean = prepare_mean(big.mean, big.y, mask2)
    mu_bar = mean(x_new[None, :])[0]
    alpha = ay - u_ones[:, None] * mu_bar[None, :]
    return big.replace(mean=mean, n=n_new, alpha=alpha, base_n=base_n,
                       ay=ay, u_ones=u_ones)


def _propose(big: BigGP, acqui, acqui_optimizer, agg, iteration, generator,
             bounded: bool):
    start = torch.full((big.dim_in,), 0.5, dtype=big.x.dtype,
                       device=big.x.device)
    return acqui_optimizer(_acq_fn(big, acqui, agg, iteration), start,
                           generator, bounded)


def make_big_propose(mesh, acqui, acqui_optimizer, aggregator=None,
                     bounded: bool = True) -> Callable:
    """The acquisition step alone, for host-evaluated objectives:
    propose(big, generator, iteration) -> (x, acquisition value).  Pairs
    with make_big_add in the ask/tell flow (bo.distributed.
    DistributedBOptimizer); every rank's generator is seeded alike."""
    from limbo_tpu_torch.acqui.acqui import FirstElem

    agg = aggregator if aggregator is not None else FirstElem

    def run(big, generator, iteration):
        res = _propose(big, acqui, acqui_optimizer, agg, iteration,
                       generator, bounded)
        return res.x, res.value

    return run


def make_big_add(mesh) -> Callable:
    """The distributed append: add(big, x, y) -> big (the state passed in
    is updated in place)."""

    def run(big, x_new, y_new):
        return _big_add(big, x_new, y_new, big.axis)

    return run


def make_big_bo_iter(mesh, f: Callable, acqui, acqui_optimizer,
                     aggregator=None, bounded: bool = True) -> Callable:
    """One BO iteration at beyond-one-card n: the column-split acquisition
    and the distributed-solve append.  iter_fn(big, generator, iteration)
    -> (big, x, y), with f a torch function of the point on the device."""
    from limbo_tpu_torch.acqui.acqui import FirstElem

    agg = aggregator if aggregator is not None else FirstElem

    def run(big, generator, iteration):
        res = _propose(big, acqui, acqui_optimizer, agg, iteration,
                       generator, bounded)
        y = f(res.x).to(big.x.dtype)
        return _big_add(big, res.x, y, big.axis), res.x, y

    return run
