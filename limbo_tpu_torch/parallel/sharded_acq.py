"""Column-sharded cached acquisition + deferred append over the mesh (port
of limbo_tpu/parallel/sharded_acq.py).

At large n the BO iteration is bound by the read of the N x N K^{-1}
query matrix (its bf16 mirror) at every ascent step.  Here that read is
split: K^{-1} and its mirror live as column panels, each rank contracting
its (N, N / D) panel, and one psum of the per-candidate partial quadratic
forms (q numbers) plus, in the backward pass, one all_gather of the saved
(q, N / D) partial products cross the ranks.  The ascent itself is
replicated: its own compute is small next to the panel read, and every
rank drawing from a generator seeded alike keeps the trajectories equal
bit for bit, so no rank ever diverges.

With a bf16 mirror the panel product is the exact-sum mirror kernel
(``csrc/mirror_mm.cu`` through ``ops/mirror.mirror_mm``), as on one card:
the card's bf16 GEMM truncates its sums.  The deferred append's pivot
takes two triangle matvecs on the replicated L^{-1} (``csrc/trimv.cu``);
its flush is a local (N, m) x (m, N / D) product per rank and a psum.

No counterpart upstream: limbo is single-process shared-memory.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Callable, Optional

import torch

from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.parallel.mesh import Axis, all_gather, mesh_axis, psum

# ---------------------------------------------------------------------------
# sharded symmetric quadratic form (the hot read)
# ---------------------------------------------------------------------------


def _sq_partials(ax: Axis, ks: torch.Tensor, Kq_local: torch.Tensor):
    """t_loc = ks @ Kq_local (q, N / D) in ks's dtype (the mirror kernel
    for a bf16 panel), and its rank's share of diag(ks Kinv ks^T)."""
    nloc = Kq_local.shape[1]
    off = ax.rank * nloc
    t_loc = gp_mod._mirror_mm(ks, Kq_local)
    return t_loc, torch.sum(t_loc * ks[:, off:off + nloc], dim=1)


class _ShardedSymQuad(torch.autograd.Function):
    """diag(ks Kinv ks^T) with Kinv column-split over the axis: ks is the
    full replicated (q, N) cross-covariance, Kq_local the rank's (N, N / D)
    column panel.  Forward: one local panel product and a psum of (q,)
    partial sums.  Backward (the symmetric VJP of gp._SymQuadDiag):
    d/dks = 2 (ks Kinv) = 2 concat_ranks(t_loc), one all_gather of the
    saved partials instead of a second panel read
    (limbo_tpu/parallel/sharded_acq.py:74-80)."""

    @staticmethod
    def forward(ctx, ks, Kq_local, ax):
        t_loc, s_loc = _sq_partials(ax, ks, Kq_local)
        ctx.save_for_backward(t_loc)
        ctx.ax = ax
        return psum(s_loc, ax)

    @staticmethod
    def backward(ctx, g):
        (t_loc,) = ctx.saved_tensors
        t_full = all_gather(t_loc, ctx.ax, dim=1)             # (q, N)
        return (2.0 * g)[:, None] * t_full, None, None


def _sharded_sym_quad(ax: Axis, ks: torch.Tensor,
                      Kq_local: torch.Tensor) -> torch.Tensor:
    return _ShardedSymQuad.apply(ks, Kq_local, ax)


def _pending_correction(ks, P, pend):
    """diag(ks (P P^T - diag(pend)) ks^T): the deferred pivots not yet
    flushed into the panels (replicated, O(q N m))."""
    return (torch.sum((ks @ P) ** 2, dim=1)
            - torch.sum(ks * ks * pend[None, :], dim=1))


# ---------------------------------------------------------------------------
# the sharded cached-GP view (duck-typed model for the acquisition layer)
# ---------------------------------------------------------------------------

class GPSurfaceFwd:
    """Property-forwarding mixin: the read-only GP surface the acquisition
    layer reads (kernel, mean, x, y, n, n_dev, mask, capacity, dims),
    delegated to a `gp` field, shared by every per-rank view."""

    @property
    def kernel(self):
        return self.gp.kernel

    @property
    def mean(self):
        return self.gp.mean

    @property
    def x(self):
        return self.gp.x

    @property
    def y(self):
        return self.gp.y

    @property
    def n(self):
        return self.gp.n

    @property
    def n_dev(self):
        return self.gp.n_dev

    @property
    def mask(self):
        return self.gp.mask

    @property
    def capacity(self):
        return self.gp.capacity

    @property
    def dim_in(self):
        return self.gp.dim_in

    @property
    def dim_out(self):
        return self.gp.dim_out


@dataclass
class ShardColsGPView(GPSurfaceFwd):
    """A rank's view of (GP, QueryCache) with K^{-1} column-split: the GP
    replicated, the cache's Kinv / Kinv_q (and K) the rank's column panels
    (``shard_cache_cols``).  models.dispatch.query_any routes it through
    ``query_posterior``, so the acquisitions and optimizers take it as
    they take a GP."""

    gp: gp_mod.GP
    cache: gp_mod.QueryCache
    axis: Axis

    def query_posterior(self, Xq: torch.Tensor):
        return sharded_query_cached(self, Xq)


def sharded_query_cached(view: ShardColsGPView, Xq: torch.Tensor):
    """query_cached with the variance's quadratic form column-split.  The
    mean (the alpha product, N p) and the pending-pivot correction (N m)
    are replicated: small next to the (N, N / D) panel each rank reads."""
    gp, cache = view.gp, view.cache
    Xq = torch.atleast_2d(torch.as_tensor(Xq, device=gp.x.device)
                          ).to(gp.x.dtype)
    ks = gp.kernel.gram(Xq, gp.x) * gp.mask[None, :]            # (q, N)
    mu = ks @ gp.alpha + gp.mean(Xq)
    Kq = cache.Kinv_q if cache.Kinv_q is not None else cache.Kinv
    quad = _sharded_sym_quad(view.axis, ks, Kq)
    if cache.P is not None:
        idx = torch.arange(gp.capacity, device=ks.device)
        pend = ((idx >= cache.base_n_dev) & (idx < gp.n_dev)).to(ks.dtype)
        quad = quad + _pending_correction(ks, cache.P, pend)
    var = gp.kernel.k_diag(Xq) - quad
    return mu, gp_mod._clamp0(var)


# ---------------------------------------------------------------------------
# sharded deferred append
# ---------------------------------------------------------------------------

def _flush_panel(Kinv_loc, P, pend, rhs, ax: Axis):
    """The deferred flush of one rank's column panel, in place:
    Kinv[:, cols] += P P[cols]^T and the pending identity slots (``pend``,
    (N,)) cancelled on its diagonal entries; returns
    psum(Kinv[:, cols] rhs[cols]) = K^{-1} rhs, the ay / u_ones refresh."""
    nloc = Kinv_loc.shape[1]
    off = ax.rank * nloc
    Kinv_loc.addmm_(P, P[off:off + nloc].T)
    torch.diagonal(Kinv_loc[off:off + nloc]).sub_(pend[off:off + nloc])
    return psum(Kinv_loc @ rhs[off:off + nloc], ax)


def _flush_cols(ax: Axis, cache: gp_mod.QueryCache, pend, rhs):
    """models/gp._add_sample_deferred's flush over column panels: the
    rank's Kinv panel and its mirror."""
    a = _flush_panel(cache.Kinv, cache.P, pend, rhs, ax)
    if cache.Kinv_q is not None:
        cache.Kinv_q.copy_(cache.Kinv)
    return a


def sharded_add_deferred(view: ShardColsGPView, x_new: torch.Tensor,
                         y_new: torch.Tensor) -> ShardColsGPView:
    """The deferred cached append (models/gp._add_sample_deferred) with
    Kinv / mirror column panels.  The same code; the split pieces are the
    flush, (P P^T)[:, cols] = P P[cols]^T as a local (N, m) x (m, N / D)
    product, and the ay / u_ones refresh, whose K^{-1} rhs contraction is
    a psum over the panels.  Row i of x, y, L and Linv, P's pending column
    and the panels are written in place."""
    gp, cache = view.gp, view.cache
    if cache.Kinv is None:
        raise ValueError("sharded deferred updates need the f32 K^{-1} "
                         "master (lite caches are not supported on this "
                         "path; see parallel.sharded_big)")
    gp, cache = gp_mod._add_sample_deferred(
        gp, cache, *gp_mod._append_terms(gp, x_new, y_new),
        flush_into=partial(_flush_cols, view.axis))
    return replace(view, gp=gp, cache=cache)


# ---------------------------------------------------------------------------
# placement and the BO iteration
# ---------------------------------------------------------------------------

_COLS = ("Kinv", "K", "Kinv_q")


def cache_specs(axis: str, cache: gp_mod.QueryCache) -> gp_mod.QueryCache:
    """The placement of each field of a QueryCache, as a QueryCache of
    labels: "cols" (column panels over `axis`) for Kinv, K and Kinv_q,
    "replicated" for the rest, None where the cache has no such field."""
    labels = {f.name: (None if getattr(cache, f.name) is None
                       else f"cols:{axis}" if f.name in _COLS
                       else "replicated")
              for f in gp_mod.QueryCache.__dataclass_fields__.values()
              if f.name not in ("base_n", "base_n_dev")}
    return gp_mod.QueryCache(**labels)


def shard_cache_cols(mesh, cache: gp_mod.QueryCache,
                     axis: Optional[str] = None) -> gp_mod.QueryCache:
    """This rank's QueryCache from a replicated one: K^{-1}, K and the
    mirror reduced to the rank's contiguous column panels, the rest
    shared."""
    ax = mesh_axis(mesh, axis)
    if cache.Kinv is None:
        raise ValueError(
            "lite caches (Kinv=None) cannot be column-sharded here: use "
            "parallel.sharded_big (which shards the factor too) or build "
            "the cache without lite=True")
    N = cache.Kinv.shape[1]
    if N % ax.size != 0:
        raise ValueError(f"capacity {N} not divisible by mesh axis "
                         f"{ax.size} (pad the capacity)")
    nloc = N // ax.size
    cols = slice(ax.rank * nloc, (ax.rank + 1) * nloc)
    return cache.replace(**{f: getattr(cache, f)[:, cols].contiguous()
                            for f in _COLS if getattr(cache, f) is not None})


def make_sharded_bo_iter(mesh, f: Callable, acqui, acqui_optimizer,
                         aggregator=None, bounded: bool = True,
                         axis: Optional[str] = None) -> Callable:
    """One large-n BO iteration over the mesh: the replicated acquisition
    maximization reading column panels of K^{-1}, the objective (a torch
    function of the point on the device) and the sharded deferred append.

    Returns iter_fn(gp, cache, generator, iteration) -> (gp, cache, x, y);
    `cache` is built with with_Linv=True and defer_m > 0 and placed by
    shard_cache_cols, and every rank's generator is seeded alike.  The
    state passed in is updated in place (see models/gp.py)."""
    from limbo_tpu_torch.acqui.acqui import FirstElem

    agg = aggregator if aggregator is not None else FirstElem
    ax = mesh_axis(mesh, axis)

    def run(gp, cache, generator, iteration):
        view = ShardColsGPView(gp=gp, cache=cache, axis=ax)
        res = acqui_optimizer(_acq_fn(view, acqui, agg, iteration),
                              torch.full((gp.dim_in,), 0.5,
                                         dtype=gp.x.dtype,
                                         device=gp.x.device),
                              generator, bounded)
        y = f(res.x).to(gp.x.dtype)
        view = sharded_add_deferred(view, res.x, y)
        return view.gp, view.cache, res.x, y

    return run


def _acq_fn(view, acqui, agg, iteration):
    """The acquisition over a per-rank view (EI's best prediction taken
    once per iteration)."""
    from limbo_tpu_torch.acqui.acqui import EI

    if isinstance(acqui, EI):
        with torch.no_grad():
            f_max = acqui.best_predicted(view, agg)
        return lambda X: acqui(view, X, agg, iteration, f_max=f_max)
    return lambda X: acqui(view, X, agg, iteration)
