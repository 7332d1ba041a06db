"""Exact Gaussian-process regression (port of limbo_tpu/models/gp.py).

limbo's model::GP (src/limbo/model/gp.hpp:78): fit, incremental rank-1
Cholesky updates and posterior queries, plus the reference's K^{-1} query
cache for large n.

* **Padded fixed-capacity buffers.**  The dataset lives in (capacity, d)
  tensors with a valid count; the padded block of the kernel matrix is the
  identity (utils.maths.masked_identity_gram).  The count is kept twice:
  ``n`` (and the cache's ``base_n``), a Python int for what the host decides
  without waiting on the card (capacity checks, the deferred flush cadence,
  slicing the valid rows), and ``n_dev`` (``base_n_dev``), a 0-d int64
  tensor on the GP's device, the reference's int32 array
  (limbo_tpu/models/gp.py:72, :391).  Every read on an iteration's path
  (the mask, the rows an append writes, the pending-pivot column, the
  pending mask of a query) takes the tensor, so a captured iteration
  (bo/graph.py) replays with the row of its replay and not of its capture.
* **Updates in place.**  Where the reference donates the GP and cache
  buffers to a jitted step (bench.py:106), the appends here write row ``i``
  of x, y, L and Linv, the pending-pivot column of P, and the flushed K^{-1}
  and its mirror in place (``index_copy_`` at the device count): the GP and
  cache passed in share those tensors with the ones returned, and must not
  be used afterwards.  alpha, the mean, ``ay``, ``u_ones`` and the counts
  come back as new tensors; bo/graph.py copies them into its captured ones.
* **Multi-output convention** as limbo: one shared kernel matrix for all
  ``p`` outputs, observations (n, p), alpha (n, p).

The objectives (``log_lik``, ``log_marginal_likelihood``, ``log_loo_cv``
and ``log_loo_cv_fn``) are differentiable scalars: on the card at large N
their factorization is the blocked Cholesky with the panel-factor kernel,
and their gradient runs the Cholesky pullback through the tri-inv panel
kernel (ops/chol.py).

The K^{-1} cache (``QueryCache``) comes in the reference's forms: with the
f32 master ``Kinv``, optionally the covariance ``K`` ("refined" appends), the
inverse factor ``Linv`` ("linv" and "deferred" appends) and a low-precision
query mirror; and "lite", the mirror alone beside ``Linv``, the form that
holds the exact GP at n = 32k on one card.  A low-precision lite mirror is
made from ``Linv`` panel by panel (``_mirror_from_linv``), at the build and
at every deferred flush, so no f32 N x N K^{-1} is ever allocated.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from limbo_tpu_torch.kernels.base import effective_jitter
from limbo_tpu_torch.means.means import prepare_mean
from limbo_tpu_torch.ops.chol import cholesky, tri_inv, use_blocked_tri
from limbo_tpu_torch.ops.mirror import mirror_mm
from limbo_tpu_torch.ops.trimv import trimv
from limbo_tpu_torch.utils.device import resolve_device

DEFAULT_CAPACITY = 256


def _round_capacity(n: int) -> int:
    """Round up to a multiple of 64."""
    return max(64, -(-n // 64) * 64)


def _count(n: int, device) -> torch.Tensor:
    """A count as a 0-d int64 tensor on `device` (a fill, no host copy)."""
    return torch.full((), int(n), dtype=torch.int64, device=device)


def _put_row(A: torch.Tensor, i: torch.Tensor, row: torch.Tensor) -> None:
    """A[i] = row in place, at the device index i (0-d)."""
    A.index_copy_(0, i.reshape(1), row.reshape(1, -1))


@dataclass
class GP:
    """Padded exact-GP state.

    Fields:
      kernel, mean: hyperparameter modules.
      x: (N, d) padded sample buffer.       y: (N, p) padded observations.
      n: number of valid samples (Python int, for the host).
      L: (N, N) lower Cholesky factor of the masked training covariance
         (identity on the padded block).
      alpha: (N, p) = K^{-1} (y - m(x)), zero on the padded block.
      n_dev: n as a 0-d int64 tensor on x's device (made from n when not
         given), the count every read on an iteration's path takes.
    """

    kernel: object
    mean: object
    x: torch.Tensor
    y: torch.Tensor
    n: int
    L: torch.Tensor
    alpha: torch.Tensor
    n_dev: Optional[torch.Tensor] = None

    replace = dataclasses.replace

    def __post_init__(self):
        if self.n_dev is None:
            self.n_dev = _count(self.n, self.x.device)

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
                < self.n_dev).to(self.x.dtype)

    @property
    def nb_samples(self) -> int:
        return self.n

    # -- convenience wrappers (limbo GP::query / mu / sigma) ------------------

    def query(self, Xq) -> Tuple[torch.Tensor, torch.Tensor]:
        return query(self, Xq)

    def mu(self, Xq) -> torch.Tensor:
        return query(self, Xq)[0]

    def sigma_sq(self, Xq) -> torch.Tensor:
        return query(self, Xq)[1]


# ---------------------------------------------------------------------------
# construction / (re)computation
# ---------------------------------------------------------------------------

def empty(kernel, mean, dim_in: int, dim_out: int = 1,
          capacity: int = DEFAULT_CAPACITY, device="cuda",
          dtype=torch.float32) -> GP:
    """A GP with no samples (query returns the prior; limbo gp.hpp:159-171)."""
    dev = resolve_device(device)
    N = capacity
    return GP(kernel=kernel, mean=mean,
              x=torch.zeros((N, dim_in), dtype=dtype, device=dev),
              y=torch.zeros((N, dim_out), dtype=dtype, device=dev),
              n=0, L=torch.eye(N, dtype=dtype, device=dev),
              alpha=torch.zeros((N, dim_out), dtype=dtype, device=dev))


def fit(kernel, mean, X, Y, capacity: Optional[int] = None, device="cuda",
        dtype=None) -> GP:
    """Full GP fit (limbo GP::compute, gp.hpp:88): pad, factorize, solve.

    X: (n, d), Y: (n, p) (tensors or arrays).  dtype defaults to X's
    floating dtype; capacity defaults to n rounded up to 64.
    """
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    dtype = dtype if dtype is not None else (
        X.dtype if X.is_floating_point() else torch.float32)
    X = torch.atleast_2d(X.to(dtype))
    Y = torch.atleast_2d(torch.as_tensor(Y, device=dev).to(dtype))
    n, d = X.shape
    p = Y.shape[1]
    N = capacity if capacity is not None else _round_capacity(n)
    if N < n:
        raise ValueError(f"capacity {N} < n {n}")
    xpad = torch.zeros((N, d), dtype=dtype, device=dev)
    xpad[:n] = X
    ypad = torch.zeros((N, p), dtype=dtype, device=dev)
    ypad[:n] = Y
    gp = GP(kernel=kernel, mean=mean, x=xpad, y=ypad, n=n,
            L=torch.eye(N, dtype=dtype, device=dev),
            alpha=torch.zeros((N, p), dtype=dtype, device=dev))
    return recompute(gp)


def recompute(gp: GP, update_obs_mean: bool = True) -> GP:
    """Re-factorize from stored data (limbo GP::recompute, gp.hpp:241).

    One fused kernel pass builds the padded covariance on the card; if the
    factorization goes indefinite, it is redone once with a ridge that
    follows the f32 accumulation-error model, 32 * eps_eff * N * max|diag K|
    (limbo_tpu/models/gp.py:159-181).  That check waits on the card once.
    """
    mask = gp.mask
    mean = prepare_mean(gp.mean, gp.y, mask) if update_obs_mean else gp.mean
    K = gp.kernel.gram_train_masked(gp.x, gp.n)
    L = cholesky(K)
    if not bool(torch.isfinite(L).all()):
        esc = (32.0 * effective_jitter(K.dtype) * K.shape[0]
               * torch.max(torch.abs(torch.diagonal(K))))
        L = cholesky(K + esc * torch.eye(K.shape[0], dtype=K.dtype,
                                         device=K.device))
    centered = (gp.y - mean(gp.x)) * mask[:, None]
    return gp.replace(mean=mean, L=L, alpha=_cho_solve(L, centered))


def _cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    z = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.T, z, upper=True)


def _solve_vec(L: torch.Tensor, b: torch.Tensor, upper: bool = False):
    return torch.linalg.solve_triangular(L, b[:, None], upper=upper)[:, 0]


# ---------------------------------------------------------------------------
# incremental update (rank-1 Cholesky)
# ---------------------------------------------------------------------------

def add_sample(gp: GP, x_new, y_new) -> GP:
    """O(N^2) incremental update (limbo GP::add_sample +
    _compute_incremental_kernel, gp.hpp:126,573-603).

    Appends one (d,), (p,) sample at index n: the new Cholesky row is
    l = L^{-1} k_new, rescaled so that |l|^2 <= kxx - floor (the PSD guard of
    limbo_tpu/models/gp.py:217-233); alpha is re-solved, and an append that
    leaves alpha or the row non-finite refits from the stored data (that
    check waits on the card).  Row n of x, y and L is written in place.
    """
    gp2, ok = add_sample_ok(gp, x_new, y_new)
    if not bool(ok):
        return recompute(gp2)
    return gp2


def add_sample_ok(gp: GP, x_new, y_new) -> Tuple[GP, torch.Tensor]:
    """add_sample without its retry: the appended GP and a 0-d bool tensor,
    true when alpha and the new row are finite.  Nothing here waits on the
    card; the caller decides (add_sample refits when it is false, the
    captured step reads it after its replay, as the reference's lax.cond
    does on the device)."""
    i = gp.n
    if i >= gp.capacity:
        raise ValueError(f"GP is full (capacity {gp.capacity})")
    mask = gp.mask
    dtype = gp.x.dtype
    x_new = torch.as_tensor(x_new, dtype=dtype, device=gp.x.device)
    y_new = torch.as_tensor(y_new, dtype=dtype, device=gp.x.device)

    k_vec = gp.kernel.gram(x_new[None, :], gp.x)[0] * mask          # (N,)
    l = _solve_vec(gp.L, k_vec)                                      # (N,)
    diag_add = gp.kernel.train_diag_add(x_new[None, :])[0]
    kxx = gp.kernel.k_diag(x_new[None, :])[0] + diag_add
    ll = torch.dot(l, l)
    floor = torch.maximum(diag_add, effective_jitter(dtype) * kxx)
    ll_clamped = torch.minimum(ll, kxx - floor)
    l = l * torch.sqrt(ll_clamped
                       / torch.clamp(ll, min=torch.finfo(dtype).tiny))
    d = torch.sqrt(kxx - ll_clamped)

    e_i = _onehot(gp.capacity, gp.n_dev, gp.x)
    new_row = l * mask + d * e_i
    _put_row(gp.L, gp.n_dev, new_row)
    _put_row(gp.x, gp.n_dev, x_new)
    _put_row(gp.y, gp.n_dev, y_new)
    gp2 = gp.replace(n=i + 1, n_dev=gp.n_dev + 1)
    mask2 = gp2.mask
    mean = prepare_mean(gp2.mean, gp2.y, mask2)
    centered = (gp2.y - mean(gp2.x)) * mask2[:, None]
    alpha = _cho_solve(gp2.L, centered)
    ok = torch.isfinite(alpha).all() & torch.isfinite(new_row).all()
    return gp2.replace(mean=mean, alpha=alpha), ok


def _onehot(N: int, i: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """e_i of length N in like's dtype, for a device index i (0-d)."""
    return (torch.arange(N, device=like.device) == i).to(like.dtype)


def grow(gp: GP, new_capacity: int) -> GP:
    """Enlarge the padded buffers: L and alpha extend with an identity and
    a zero block, no refactorization."""
    N0, N1 = gp.capacity, new_capacity
    if N1 < N0:
        raise ValueError(f"new capacity {N1} < capacity {N0}")
    kw = dict(dtype=gp.x.dtype, device=gp.x.device)
    x = torch.zeros((N1, gp.dim_in), **kw)
    x[:N0] = gp.x
    y = torch.zeros((N1, gp.dim_out), **kw)
    y[:N0] = gp.y
    L = torch.eye(N1, **kw)
    L[:N0, :N0] = gp.L
    alpha = torch.zeros((N1, gp.dim_out), **kw)
    alpha[:N0] = gp.alpha
    return gp.replace(x=x, y=y, L=L, alpha=alpha)


# ---------------------------------------------------------------------------
# posterior query
# ---------------------------------------------------------------------------

def query(gp, Xq) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched posterior moments (limbo GP::query/mu/sigma, gp.hpp:159-196).

    Xq: (q, d) -> (mu (q, p), sigma_sq (q,)), the latent variance clamped
    at 0.  A CachedGPView routes through the matmul-only cached path.
    """
    if isinstance(gp, CachedGPView):
        return query_cached(gp.gp, gp.cache, Xq)
    Xq = torch.atleast_2d(torch.as_tensor(Xq, device=gp.x.device)
                          ).to(gp.x.dtype)
    ks = gp.kernel.gram(Xq, gp.x) * gp.mask[None, :]                 # (q, N)
    mu = ks @ gp.alpha + gp.mean(Xq)
    z = torch.linalg.solve_triangular(gp.L, ks.T, upper=False)       # (N, q)
    var = gp.kernel.k_diag(Xq) - torch.sum(z * z, dim=0)
    return mu, _clamp0(var)


def _clamp0(v: torch.Tensor) -> torch.Tensor:
    """max(v, 0) with the reference's gradient: jnp.maximum MULTIPLIES the
    incoming gradient by 0 at a clamped entry, so an infinite one (sqrt's
    at 0, in UCB) turns NaN there and the optimizers' guard zeroes that
    restart's step; torch.clamp would select a finite 0 instead."""
    return v * (v > 0).to(v.dtype) + 0.0


def _mirror_mm(ks: torch.Tensor, Kq: torch.Tensor) -> torch.Tensor:
    """ks @ Kq in ks's dtype.  With a bf16 mirror Kq, ks is rounded to bf16
    and the exact products are summed in ks's dtype, as the reference's
    ``preferred_element_type`` dot does (gp.py:496-497): the exact-sum
    mirror kernel on the card (f32), the upcast product on the CPU
    (ops/mirror.py)."""
    if Kq.dtype == ks.dtype:
        return ks @ Kq
    return mirror_mm(ks, Kq)


def _panel_width(N: int, cap: int = 1024) -> int:
    """Largest divisor of N not above cap: the panels of the mirror build
    tile N exactly (limbo_tpu/models/gp.py:306-311)."""
    return next(d for d in range(min(cap, N), 0, -1) if N % d == 0)


def _mirror_from_linv(Linv: torch.Tensor, qdtype, out=None,
                      cap: int = 1024) -> torch.Tensor:
    """(Linv^T Linv) in qdtype, one column panel at a time
    (limbo_tpu/models/gp.py:314-333): panel i is Linv^T Linv[:, cols_i] in
    exact f32, written transposed into rows cols_i of the mirror (K^{-1} is
    symmetric) and cast on the way, so no f32 (N, N) temporary exists.  The
    rows of Linv above the panel's first column are zero (Linv is lower
    triangular), so the product skips them.  ``out`` (N, N) in qdtype takes
    the result in place (a deferred flush rewrites the cache's mirror);
    ``cap`` bounds the panel width, which divides N."""
    N = Linv.shape[0]
    w = _panel_width(N, cap)
    if out is None:
        out = torch.empty((N, N), dtype=qdtype, device=Linv.device)
    for c0 in range(0, N, w):
        below = Linv[c0:]
        out[c0:c0 + w].copy_((below.T @ below[:, c0:c0 + w]).T)
    return out


def _linv_solve(Linv: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """K^{-1} B = Linv^T (Linv B), two passes over Linv."""
    return Linv.T @ (Linv @ B)


@dataclass
class QueryCache:
    """Precomputed K^{-1} for matmul-only queries
    (limbo_tpu/models/gp.py:336-401).

    Kinv: the f32 master inverse, None in the "lite" cache, whose mirror is
    its only N x N query matrix.  K: optionally the masked training
    covariance itself, for the "refined" append.  Linv: the inverse Cholesky
    factor L^{-1} (lower, padded identity), kept for the "linv" and
    "deferred" appends, whose pivot u = Linv^T (Linv k) comes from two
    triangle matvecs.  Kinv_q: an optional low-precision (bf16) mirror of
    Kinv, read only by the variance quadratic form (in a lite cache, the
    mirror in the GP's dtype or a lower one).  Deferred mode (defer_m > 0)
    also carries P, the (N, m) pending scaled pivots, base_n (n at the last
    flush, a Python int, with base_n_dev, the same count on the device, made
    from base_n when not given), and ay = Kinv (y mask), u_ones = Kinv mask,
    from which alpha is recovered for constant-type means.
    """

    Kinv: Optional[torch.Tensor] = None
    K: Optional[torch.Tensor] = None
    Linv: Optional[torch.Tensor] = None
    Kinv_q: Optional[torch.Tensor] = None
    P: Optional[torch.Tensor] = None
    base_n: Optional[int] = None
    ay: Optional[torch.Tensor] = None
    u_ones: Optional[torch.Tensor] = None
    base_n_dev: Optional[torch.Tensor] = None

    replace = dataclasses.replace

    def __post_init__(self):
        if self.base_n is not None and self.base_n_dev is None:
            like = next(t for t in (self.P, self.Linv, self.Kinv, self.Kinv_q)
                        if t is not None)
            self.base_n_dev = _count(self.base_n, like.device)

    @classmethod
    def build(cls, gp: GP, block: int = 1024, with_K: bool = False,
              with_Linv: bool = False, qdtype=None, defer_m: int = 0,
              lite: bool = False) -> "QueryCache":
        """Linv = L^{-1}, then Kinv = Linv^T Linv (one exact-f32 product).

        Linv comes from ``tri_inv`` (ops/chol.py): the blocked inverse with
        its panel kernel on the card from TRI_INV_MIN_N, elsewhere one
        library triangular solve.  ``block``, the reference's panel width
        for its solve (which bounds XLA's temporaries), is accepted and
        unused.  On the blocked route a lite cache with a mirror below the
        GP's precision never forms the f32 K^{-1}: the mirror comes from
        Linv panel by panel and ay / u_ones from two passes over Linv
        (limbo_tpu/models/gp.py:446-461).  ``with_K`` keeps the training
        covariance (the gram_train kernel on the card); ``lite`` needs
        ``with_Linv`` and ``defer_m`` > 0."""
        if lite and not (defer_m > 0 and with_Linv):
            raise ValueError("lite caches need with_Linv=True and "
                             "defer_m > 0 (the mirror is updated via the "
                             "maintained Linv's deferred pivots)")
        N, dtype, dev = gp.capacity, gp.x.dtype, gp.x.device
        K = gp.kernel.gram_train_masked(gp.x, gp.n) if with_K else None
        defer = {}
        if defer_m > 0:
            mask = gp.mask
            rhs = torch.cat([gp.y * mask[:, None], mask[:, None]], dim=1)
            defer = dict(P=torch.zeros((N, defer_m), dtype=dtype, device=dev),
                         base_n=gp.n, base_n_dev=gp.n_dev.clone())
        Linv = tri_inv(gp.L)
        if lite and use_blocked_tri(N, dev) and qdtype not in (None, dtype):
            a = _linv_solve(Linv, rhs)
            return cls(Linv=Linv, Kinv_q=_mirror_from_linv(Linv, qdtype),
                       ay=a[:, :-1], u_ones=a[:, -1], **defer)
        Kinv = Linv.T @ Linv
        if defer_m > 0:
            a = Kinv @ rhs
            defer.update(ay=a[:, :-1], u_ones=a[:, -1])
        if lite:
            return cls(Linv=Linv, Kinv_q=Kinv.to(qdtype) if qdtype is not None
                       else Kinv, **defer)
        return cls(Kinv=Kinv, K=K, Linv=Linv if with_Linv else None,
                   Kinv_q=Kinv.to(qdtype) if qdtype is not None else None,
                   **defer)


class _SymQuadDiag(torch.autograd.Function):
    """diag(ks @ Kinv @ ks^T) for a SYMMETRIC Kinv.

    The backward uses symmetry: d/dks [ks Kinv ks^T]_ii = 2 (ks Kinv)_i =
    2 t, reusing the forward's t instead of a second (q, N) @ (N, N)
    product (limbo_tpu/models/gp.py:483-514).  Kinv gets no gradient.
    """

    @staticmethod
    def forward(ctx, ks, Kinv):
        t = _mirror_mm(ks, Kinv)                                   # (q, N)
        ctx.save_for_backward(t)
        return torch.sum(t * ks, dim=1)

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        return (2.0 * g)[:, None] * t, None


def _corr_t(ks, Kinv, P, pend):
    t = _mirror_mm(ks, Kinv)                                       # (q, N)
    t = t + (ks @ P) @ P.T
    return t - ks * pend[None, :].to(ks.dtype)


class _SymQuadDiagCorr(torch.autograd.Function):
    """diag(ks M ks^T) for M = Kinv + P P^T - diag(pend), all symmetric: the
    deferred-update query (limbo_tpu/models/gp.py:517-552).  Same backward
    as _SymQuadDiag: 2 g t with the forward's t."""

    @staticmethod
    def forward(ctx, ks, Kinv, P, pend):
        t = _corr_t(ks, Kinv, P, pend)
        ctx.save_for_backward(t)
        return torch.sum(t * ks, dim=1)

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        return (2.0 * g)[:, None] * t, None, None, None


def _sym_quad_diag(ks, Kinv):
    return _SymQuadDiag.apply(ks, Kinv)


def _sym_quad_diag_corr(ks, Kinv, P, pend):
    return _SymQuadDiagCorr.apply(ks, Kinv, P, pend)


def query_cached(gp: GP, cache: QueryCache,
                 Xq) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matmul-only posterior query using a precomputed K^{-1}.

    With a low-precision mirror the variance's quadratic form reads the
    mirror with f32 sums; the mean always uses the f32 alpha.  The
    quadratic form's backward is the symmetric one, so an ascent step reads
    the N x N buffer once.
    """
    Xq = torch.atleast_2d(torch.as_tensor(Xq, device=gp.x.device)
                          ).to(gp.x.dtype)
    mask = gp.mask
    ks = gp.kernel.gram(Xq, gp.x) * mask[None, :]                    # (q, N)
    mu = ks @ gp.alpha + gp.mean(Xq)
    Kq = cache.Kinv_q if cache.Kinv_q is not None else cache.Kinv
    if cache.P is not None:
        idx = torch.arange(gp.capacity, device=ks.device)
        pend = ((idx >= cache.base_n_dev) & (idx < gp.n_dev)).to(ks.dtype)
        quad = _sym_quad_diag_corr(ks, Kq, cache.P, pend)
    else:
        quad = _sym_quad_diag(ks, Kq)
    var = gp.kernel.k_diag(Xq) - quad
    return mu, _clamp0(var)


@dataclass
class CachedGPView:
    """A GP whose queries go through the K^{-1} cache; acquisitions take it
    like a GP (models/dispatch.query_any)."""

    gp: GP
    cache: QueryCache

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


def add_sample_cached(gp: GP, cache: QueryCache, x_new, y_new,
                      fast_update=False, flush: Optional[bool] = None
                      ) -> Tuple[GP, QueryCache]:
    """add_sample + O(N^2) block-inverse update of the K^{-1} cache
    (limbo_tpu/models/gp.py:632-775).

    With s = kappa - k^T K^{-1} k and u = K^{-1} k masked, the bordered
    inverse is Kinv' = Kinv + (u - e_i)(u - e_i)^T / s - e_i e_i^T.  The
    pivot u comes from:
      * ``fast_update=False``   - two triangular solves on L;
      * ``fast_update="refined"`` - u = Kinv k polished by one
        iterative-refinement step against the cached K
        (QueryCache.build(with_K=True)): matvecs only;
      * ``fast_update="linv"``  - two triangle matvecs on the maintained
        Linv (QueryCache.build(with_Linv=True)), whose bordered row
        -(u/d)^T is then free;
      * ``fast_update=True``    - raw u = Kinv k, fastest and drifting with
        every append (pair it with a short refresh period); refused on a
        cache with Linv, whose solve-grade rows it would corrupt;
      * ``fast_update="deferred"`` - as "linv", with the N x N rewrite
        amortized into one GEMM per defer_m appends (_add_sample_deferred).
    With a matvec pivot the Cholesky row is l = L^T u.  s is clipped to
    [max(diag_add, eps_eff * kappa), kappa], the Schur floor that keeps
    every bordered update positive definite (limbo_tpu/models/gp.py:
    676-684).  Kinv, its mirror, K's row and column i and row i of x, y, L
    and Linv are updated in place.  ``flush`` (deferred mode only) forces
    the flush of the pending pivots on or off; by default it happens when P
    is full, by the host counts.  A captured iteration is captured once
    with and once without it (bo/graph.py).
    """
    i = gp.n
    if i >= gp.capacity:
        raise ValueError(f"GP is full (capacity {gp.capacity})")
    mask = gp.mask
    dtype = gp.x.dtype
    x_new = torch.as_tensor(x_new, dtype=dtype, device=gp.x.device)
    y_new = torch.as_tensor(y_new, dtype=dtype, device=gp.x.device)

    k_vec = gp.kernel.gram(x_new[None, :], gp.x)[0] * mask           # (N,)
    diag_add = gp.kernel.train_diag_add(x_new[None, :])[0]
    kappa = gp.kernel.k_diag(x_new[None, :])[0] + diag_add
    s_floor = torch.maximum(diag_add, effective_jitter(dtype) * kappa)
    e_i = _onehot(gp.capacity, gp.n_dev, gp.x)
    if fast_update == "deferred":
        return _add_sample_deferred(gp, cache, x_new, y_new, k_vec, kappa,
                                    e_i, s_floor, flush)
    if cache.P is not None:
        raise ValueError(
            "this cache was built with defer_m > 0; immediate-update modes "
            "would leave its pending-pivot state inconsistent - use "
            "fast_update='deferred' or rebuild the cache without defer_m")
    u, l = _pivot(gp, cache, k_vec, fast_update)
    s = torch.clamp(kappa - torch.dot(k_vec, u), s_floor, kappa)
    v = u - e_i
    Kinv = cache.Kinv
    Kinv.addr_(v / s, v)
    Kinv.diagonal().sub_(e_i)          # Kinv[i, i] -= 1 at the device index
    d = torch.sqrt(s)
    _put_row(gp.L, gp.n_dev, l * mask + d * e_i)
    if cache.Linv is not None:
        _put_row(cache.Linv, gp.n_dev, -(u / d) * mask + (1.0 / d) * e_i)
    if cache.K is not None:
        # K's row and column i were e_i (the padded identity); the border
        # is k (masked, so 0 at i) + kappa e_i
        border = k_vec + kappa * e_i
        _put_row(cache.K, gp.n_dev, border)
        cache.K.index_copy_(1, gp.n_dev.reshape(1), border[:, None])
    _put_row(gp.x, gp.n_dev, x_new)
    _put_row(gp.y, gp.n_dev, y_new)
    gp2 = gp.replace(n=i + 1, n_dev=gp.n_dev + 1)
    mask2 = gp2.mask
    mean = prepare_mean(gp2.mean, gp2.y, mask2)
    centered = (gp2.y - mean(gp2.x)) * mask2[:, None]
    alpha = Kinv @ centered
    if cache.Kinv_q is not None:
        cache.Kinv_q.copy_(Kinv)
    return gp2.replace(mean=mean, alpha=alpha), cache


def _pivot(gp: GP, cache: QueryCache, k_vec, fast_update
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pivot u = K^{-1} k (masked) of an immediate append and the
    Cholesky row l = L^{-1} k, by ``fast_update``'s route (see
    add_sample_cached)."""
    mask = gp.mask
    l = None
    if fast_update == "linv":
        if cache.Linv is None:
            raise ValueError("linv updates need QueryCache.build("
                             "with_Linv=True)")
        l = trimv(cache.Linv, k_vec) * mask
        u = trimv(cache.Linv, l, transpose=True) * mask
    elif fast_update == "refined":
        if cache.K is None:
            raise ValueError("refined updates need QueryCache.build("
                             "with_K=True)")
        u = (cache.Kinv @ k_vec) * mask
        r = k_vec - cache.K @ u
        u = (u + cache.Kinv @ r) * mask
    elif fast_update is True:
        if cache.Linv is not None:
            raise ValueError(
                "fast_update=True would write drift-prone pivots into the "
                "maintained Linv; use fast_update='linv' with this cache, "
                "or build it without with_Linv")
        u = (cache.Kinv @ k_vec) * mask
    elif fast_update is False:
        l = _solve_vec(gp.L, k_vec)
        u = _solve_vec(gp.L.T, l, upper=True) * mask
    else:
        raise ValueError(f"unknown fast_update {fast_update!r}")
    if l is None:
        # u = L^{-T} L^{-1} k, so l = L^{-1} k = L^T u (one matvec)
        l = gp.L.T @ u
    return u, l


def _add_sample_deferred(gp: GP, cache: QueryCache, x_new, y_new, k_vec,
                         kappa, e_i, s_floor, flush=None
                         ) -> Tuple[GP, QueryCache]:
    """The "deferred" cached append (limbo_tpu/models/gp.py:778-884).

    The same pivot as "linv"; the correction vv^T/s - e_i e_i^T is kept as
    the scaled column v/sqrt(s) in P and applied at query time, and flushed
    into Kinv and its mirror with one (N, m) @ (m, N) product when P is
    full (or as ``flush`` says).  A lite cache flushes into its mirror: in
    place when the mirror has the GP's dtype, else by rebuilding it from
    the maintained Linv (_mirror_from_linv), with ay and u_ones re-derived
    from Linv.  Between flushes alpha comes from the exact bordered
    recurrences of ay and u_ones (constant-type means only).
    """
    if cache.Linv is None or cache.P is None:
        raise ValueError("deferred updates need QueryCache.build("
                         "with_Linv=True, defer_m > 0)")
    from limbo_tpu_torch.means.means import ConstantMean, DataMean, NullMean
    if not isinstance(gp.mean, (NullMean, ConstantMean, DataMean)):
        raise ValueError(
            "fast_update='deferred' supports constant-type means only "
            "(NullMean/ConstantMean/DataMean); FunctionARD needs the dense "
            "alpha path - use fast_update='linv'")
    i, i_dev = gp.n, gp.n_dev
    m = cache.P.shape[1]
    count = i - cache.base_n              # pivots pending BEFORE this append
    if count >= m:
        raise ValueError(f"{count} pivots pending, P holds {m}: a flush was "
                         "skipped")
    if flush is None:
        flush = count + 1 >= m
    mask = gp.mask
    l = trimv(cache.Linv, k_vec) * mask
    u = trimv(cache.Linv, l, transpose=True) * mask
    s = torch.clamp(kappa - torch.dot(k_vec, u), s_floor, kappa)
    d = torch.sqrt(s)
    v = u - e_i
    _put_row(gp.L, i_dev, l * mask + d * e_i)
    _put_row(cache.Linv, i_dev, -(u / d) * mask + (1.0 / d) * e_i)
    _put_row(gp.x, i_dev, x_new)
    _put_row(gp.y, i_dev, y_new)
    gp2 = gp.replace(n=i + 1, n_dev=i_dev + 1)
    mask2 = gp2.mask
    ym = gp2.y * mask2[:, None]
    # exact bordered recurrences (O(N p)); v is masked so padded rows stay 0
    ay = cache.ay + v[:, None] * ((v @ ym) / s)[None, :]
    u_ones = cache.u_ones + v * (torch.dot(v, mask2) / s)
    P = cache.P
    P.index_copy_(1, (i_dev - cache.base_n_dev).reshape(1), (v / d)[:, None])
    if flush:
        # flush: one (N, m) @ (m, N) GEMM into Kinv, the diagonal cancel of
        # the m pending identity slots, the mirror refresh, and ay/u_ones
        # re-derived from the fresh Kinv so recurrence rounding never
        # outlives a flush window
        idx = torch.arange(gp.capacity, device=P.device)
        pend = ((idx >= cache.base_n_dev) & (idx <= i_dev)).to(P.dtype)
        rhs = torch.cat([ym, mask2[:, None]], dim=1)
        Kinv = cache.Kinv
        if Kinv is not None:
            Kinv.addmm_(P, P.T)
            Kinv.diagonal().sub_(pend)
            a = Kinv @ rhs
            if cache.Kinv_q is not None:
                cache.Kinv_q.copy_(Kinv)
        else:
            # lite: the mirror is the only N x N query matrix
            mirror = cache.Kinv_q
            if mirror.dtype == P.dtype:
                mirror.addmm_(P, P.T)
                mirror.diagonal().sub_(pend)
            else:
                # a low-precision mirror absorbs an in-place rank-m add
                # (the correction is below its rounding step, which left
                # the variance off by O(prior) in the reference's
                # measurement, limbo_tpu/models/gp.py:849-857): rebuild it
                # from the maintained Linv, panel by panel, in place
                _mirror_from_linv(cache.Linv, mirror.dtype, out=mirror)
            a = _linv_solve(cache.Linv, rhs)
        P.zero_()
        cache = cache.replace(base_n=i + 1, base_n_dev=i_dev + 1,
                              ay=a[:, :-1], u_ones=a[:, -1])
    else:
        cache = cache.replace(ay=ay, u_ones=u_ones)
    mean = prepare_mean(gp2.mean, gp2.y, mask2)
    mu_bar = mean(x_new[None, :])[0]      # constant-type means: (p,)
    alpha = cache.ay - cache.u_ones[:, None] * mu_bar[None, :]
    return gp2.replace(mean=mean, alpha=alpha), cache



# ---------------------------------------------------------------------------
# objectives (differentiable scalars)
# ---------------------------------------------------------------------------

def _lml_terms(L: torch.Tensor, centered: torch.Tensor, alpha: torch.Tensor,
               n: int) -> torch.Tensor:
    """-0.5 tr(C^T alpha) - 0.5 logdet K - 0.5 n log 2 pi; the padded
    diagonal of L is 1, so its log terms vanish."""
    a = torch.sum(centered * alpha)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return -0.5 * a - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi)


def log_lik(gp: GP) -> torch.Tensor:
    """Log marginal likelihood of the current factorization (limbo
    GP::compute_log_lik, gp.hpp:267-281; limbo_tpu/models/gp.py:891-905).
    logdet and 2 pi are counted once whatever dim_out (limbo's multi-output
    generalization)."""
    centered = (gp.y - gp.mean(gp.x)) * gp.mask[:, None]
    return _lml_terms(gp.L, centered, gp.alpha, gp.n)


def _objective_factor(kernel, mean, x, y, n: int, extra_jitter):
    """(L, centered, alpha, mask) of the objective's training covariance."""
    mask = (torch.arange(x.shape[0], device=x.device) < n).to(x.dtype)
    mean = prepare_mean(mean, y, mask)
    K = kernel.gram_train_masked(x, n, extra_jitter=extra_jitter)
    L = cholesky(K)             # differentiable: the reference's pullback
    centered = (y - mean(x)) * mask[:, None]
    return L, centered, _cho_solve(L, centered), mask


def log_marginal_likelihood(kernel, mean, x: torch.Tensor, y: torch.Tensor,
                            n: int, extra_jitter=None) -> torch.Tensor:
    """LML as a differentiable function of the (kernel, mean) parameters,
    the hyperparameter-learning objective (limbo_tpu/models/gp.py:908-934;
    autograd replaces limbo's hand-derived gradients, gp.hpp:285-337).

    extra_jitter adds a parameter-independent ridge to the objective's
    kernel diagonal only (the fitted GP is untouched): the hp-opt
    strategies' f32 conditioning floor."""
    L, centered, alpha, _ = _objective_factor(kernel, mean, x, y, int(n),
                                              extra_jitter)
    return _lml_terms(L, centered, alpha, int(n))


def inv_kernel(gp: GP) -> torch.Tensor:
    """K^{-1} via two triangular solves (limbo compute_inv_kernel,
    gp.hpp:254)."""
    eye = torch.eye(gp.capacity, dtype=gp.x.dtype, device=gp.x.device)
    return _cho_solve(gp.L, eye)


def _loo_terms(Kinv: torch.Tensor, alpha: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    inv_diag = 1.0 / torch.diagonal(Kinv)                            # (N,)
    per = (-0.5 * (alpha ** 2) * inv_diag[:, None]
           - 0.5 * torch.log(inv_diag)[:, None]
           - 0.5 * math.log(2.0 * math.pi))
    return torch.sum(per * mask[:, None])


def log_loo_cv(gp: GP) -> torch.Tensor:
    """Leave-one-out predictive log probability (limbo
    GP::compute_log_loo_cv, gp.hpp:339-351; Rasmussen & Williams 5.4.2),
    masked over the valid samples."""
    return _loo_terms(inv_kernel(gp), gp.alpha, gp.mask)


def log_loo_cv_fn(kernel, mean, x: torch.Tensor, y: torch.Tensor, n: int,
                  extra_jitter=None) -> torch.Tensor:
    """LOO-CV as a differentiable function of the hyperparameters (the
    KernelLooOpt objective; limbo_tpu/models/gp.py:959-976)."""
    L, _, alpha, mask = _objective_factor(kernel, mean, x, y, int(n),
                                          extra_jitter)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    return _loo_terms(_cho_solve(L, eye), alpha, mask)


# ---------------------------------------------------------------------------
# data access (limbo samples() / observations() / mean_observation())
# ---------------------------------------------------------------------------

def samples(gp: GP) -> torch.Tensor:
    """The valid samples, (n, d)."""
    return gp.x[:gp.n]


def observations(gp: GP) -> torch.Tensor:
    """The valid observations, (n, p)."""
    return gp.y[:gp.n]


def mean_observation(gp: GP) -> torch.Tensor:
    """Column means of the valid observations (limbo
    gp.mean_observation())."""
    m = gp.mask
    return torch.sum(gp.y * m[:, None], dim=0) / torch.clamp(torch.sum(m),
                                                             min=1.0)
