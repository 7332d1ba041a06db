"""Exact Gaussian-process regression (port of limbo_tpu/models/gp.py).

limbo's model::GP (src/limbo/model/gp.hpp:78): fit, incremental rank-1
Cholesky updates and posterior queries, plus the reference's K^{-1} query
cache for large n.

* **Padded fixed-capacity buffers.**  The dataset lives in (capacity, d)
  tensors with a valid count ``n``; the padded block of the kernel matrix is
  the identity (utils.maths.masked_identity_gram).  ``n`` (and the cache's
  ``base_n``) are Python ints: the host loop needs them without waiting on
  the card, and the reference's ``lax.cond`` on them become Python ``if``s.
* **Updates in place.**  Where the reference donates the GP and cache
  buffers to a jitted step (bench.py:106), the appends here write row ``i``
  of x, y, L and Linv, the pending-pivot column of P, and the flushed K^{-1}
  and its mirror in place: the GP and cache passed in share those tensors
  with the ones returned, and must not be used afterwards.
* **Multi-output convention** as limbo: one shared kernel matrix for all
  ``p`` outputs, observations (n, p), alpha (n, p).

Not ported yet: ``log_lik``, ``log_marginal_likelihood`` and the LOO
objectives (with hyperparameter learning), the cache's ``with_K`` / ``lite``
forms and the ``"refined"`` update that needs ``with_K``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from limbo_tpu_torch.kernels.base import effective_jitter
from limbo_tpu_torch.means.means import prepare_mean
from limbo_tpu_torch.ops.chol import cholesky, tri_inv
from limbo_tpu_torch.ops.trimv import trimv
from limbo_tpu_torch.utils.device import resolve_device

DEFAULT_CAPACITY = 256


def _round_capacity(n: int) -> int:
    """Round up to a multiple of 64."""
    return max(64, -(-n // 64) * 64)


@dataclass
class GP:
    """Padded exact-GP state.

    Fields:
      kernel, mean: hyperparameter modules.
      x: (N, d) padded sample buffer.       y: (N, p) padded observations.
      n: number of valid samples (Python int).
      L: (N, N) lower Cholesky factor of the masked training covariance
         (identity on the padded block).
      alpha: (N, p) = K^{-1} (y - m(x)), zero on the padded block.
    """

    kernel: object
    mean: object
    x: torch.Tensor
    y: torch.Tensor
    n: int
    L: torch.Tensor
    alpha: torch.Tensor

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

    e_i = _onehot(gp.capacity, i, gp.x)
    new_row = l * mask + d * e_i
    gp.L[i] = new_row
    gp.x[i] = x_new
    gp.y[i] = y_new
    gp2 = gp.replace(n=i + 1)
    mask2 = gp2.mask
    mean = prepare_mean(gp2.mean, gp2.y, mask2)
    centered = (gp2.y - mean(gp2.x)) * mask2[:, None]
    alpha = _cho_solve(gp2.L, centered)
    ok = torch.isfinite(alpha).all() & torch.isfinite(new_row).all()
    if not bool(ok):
        return recompute(gp2)
    return gp2.replace(mean=mean, alpha=alpha)


def _onehot(N: int, i: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros((N,), dtype=like.dtype, device=like.device)
    e[i] = 1.0
    return e


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
    """ks @ Kq in ks's dtype.  With a low-precision mirror Kq, ks is
    rounded to Kq's dtype and the products are summed in ks's dtype, as the
    reference's ``preferred_element_type`` dot does (gp.py:496-497): on the
    card through the mixed-dtype GEMM, on the CPU by upcasting both operands
    (the same exact products)."""
    if Kq.dtype == ks.dtype:
        return ks @ Kq
    kq = ks.to(Kq.dtype)
    if ks.device.type == "cuda":
        return torch.mm(kq, Kq, out_dtype=ks.dtype)
    return kq.to(ks.dtype) @ Kq.to(ks.dtype)


@dataclass
class QueryCache:
    """Precomputed K^{-1} for matmul-only queries.

    Kinv: the f32 master inverse.  Linv: the inverse Cholesky factor L^{-1}
    (lower, padded identity), kept for the "linv" and "deferred" appends,
    whose pivot u = Linv^T (Linv k) comes from two triangle matvecs.  Kinv_q:
    an optional low-precision (bf16) mirror of Kinv, read only by the
    variance quadratic form.  Deferred mode (defer_m > 0) also carries P,
    the (N, m) pending scaled pivots, base_n (n at the last flush, a Python
    int), and ay = Kinv (y mask), u_ones = Kinv mask, from which alpha is
    recovered for constant-type means.  See limbo_tpu/models/gp.py:336-401.
    """

    Kinv: Optional[torch.Tensor] = None
    Linv: Optional[torch.Tensor] = None
    Kinv_q: Optional[torch.Tensor] = None
    P: Optional[torch.Tensor] = None
    base_n: Optional[int] = None
    ay: Optional[torch.Tensor] = None
    u_ones: Optional[torch.Tensor] = None

    replace = dataclasses.replace

    @classmethod
    def build(cls, gp: GP, with_Linv: bool = False, qdtype=None,
              defer_m: int = 0) -> "QueryCache":
        """Linv = L^{-1} (the blocked inverse with its panel kernel on the
        card from TRI_INV_MIN_N, the library solve elsewhere), then
        Kinv = Linv^T Linv (one exact-f32 product)."""
        Linv = tri_inv(gp.L)
        Kinv = Linv.T @ Linv
        defer = {}
        if defer_m > 0:
            mask = gp.mask
            rhs = torch.cat([gp.y * mask[:, None], mask[:, None]], dim=1)
            a = Kinv @ rhs
            defer = dict(P=torch.zeros((gp.capacity, defer_m),
                                       dtype=gp.x.dtype, device=gp.x.device),
                         base_n=gp.n, ay=a[:, :-1], u_ones=a[:, -1])
        return cls(Kinv=Kinv, Linv=Linv if with_Linv else None,
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
        pend = ((idx >= cache.base_n) & (idx < gp.n)).to(ks.dtype)
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
                      fast_update=False) -> Tuple[GP, QueryCache]:
    """add_sample + O(N^2) block-inverse update of the K^{-1} cache
    (limbo_tpu/models/gp.py:632-775).

    With s = kappa - k^T K^{-1} k and u = K^{-1} k masked, the bordered
    inverse is Kinv' = Kinv + (u - e_i)(u - e_i)^T / s - e_i e_i^T.  The
    pivot u comes from:
      * ``fast_update=False``   - two triangular solves on L;
      * ``fast_update="linv"``  - two triangle matvecs on the maintained
        Linv (QueryCache.build(with_Linv=True)), whose bordered row
        -(u/d)^T is then free;
      * ``fast_update="deferred"`` - as "linv", with the N x N rewrite
        amortized into one GEMM per defer_m appends (_add_sample_deferred).
    s is clipped to [max(diag_add, eps_eff * kappa), kappa], the Schur
    floor that keeps every bordered update positive definite
    (limbo_tpu/models/gp.py:676-684).  Kinv, its mirror and row i of x, y,
    L and Linv are updated in place.
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
    e_i = _onehot(gp.capacity, i, gp.x)
    if fast_update == "deferred":
        return _add_sample_deferred(gp, cache, x_new, y_new, k_vec, kappa,
                                    e_i, s_floor)
    if cache.P is not None:
        raise ValueError(
            "this cache was built with defer_m > 0; immediate-update modes "
            "would leave its pending-pivot state inconsistent - use "
            "fast_update='deferred' or rebuild the cache without defer_m")
    if fast_update == "linv":
        if cache.Linv is None:
            raise ValueError("linv updates need QueryCache.build("
                             "with_Linv=True)")
        l = trimv(cache.Linv, k_vec) * mask
        u = trimv(cache.Linv, l, transpose=True) * mask
    elif fast_update is False:
        l = _solve_vec(gp.L, k_vec)
        u = _solve_vec(gp.L.T, l, upper=True) * mask
    else:
        raise ValueError(f"fast_update={fast_update!r} is not ported; use "
                         "False, 'linv' or 'deferred'")
    s = torch.clamp(kappa - torch.dot(k_vec, u), s_floor, kappa)
    v = u - e_i
    Kinv = cache.Kinv
    Kinv.addr_(v / s, v)
    Kinv[i, i] -= 1.0
    d = torch.sqrt(s)
    gp.L[i] = l * mask + d * e_i
    if cache.Linv is not None:
        cache.Linv[i] = -(u / d) * mask + (1.0 / d) * e_i
    gp.x[i] = x_new
    gp.y[i] = y_new
    gp2 = gp.replace(n=i + 1)
    mask2 = gp2.mask
    mean = prepare_mean(gp2.mean, gp2.y, mask2)
    centered = (gp2.y - mean(gp2.x)) * mask2[:, None]
    alpha = Kinv @ centered
    if cache.Kinv_q is not None:
        cache.Kinv_q.copy_(Kinv)
    return gp2.replace(mean=mean, alpha=alpha), cache


def _add_sample_deferred(gp: GP, cache: QueryCache, x_new, y_new, k_vec,
                         kappa, e_i, s_floor) -> Tuple[GP, QueryCache]:
    """The "deferred" cached append (limbo_tpu/models/gp.py:778-884).

    The same pivot as "linv"; the correction vv^T/s - e_i e_i^T is kept as
    the scaled column v/sqrt(s) in P and applied at query time, and flushed
    into Kinv and its mirror with one (N, m) @ (m, N) product when P is
    full.  alpha comes from the exact bordered recurrences of ay and u_ones
    (constant-type means only).
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
    i = gp.n
    mask = gp.mask
    l = trimv(cache.Linv, k_vec) * mask
    u = trimv(cache.Linv, l, transpose=True) * mask
    s = torch.clamp(kappa - torch.dot(k_vec, u), s_floor, kappa)
    d = torch.sqrt(s)
    v = u - e_i
    gp.L[i] = l * mask + d * e_i
    cache.Linv[i] = -(u / d) * mask + (1.0 / d) * e_i
    gp.x[i] = x_new
    gp.y[i] = y_new
    gp2 = gp.replace(n=i + 1)
    mask2 = gp2.mask
    ym = gp2.y * mask2[:, None]
    # exact bordered recurrences (O(N p)); v is masked so padded rows stay 0
    ay = cache.ay + v[:, None] * ((v @ ym) / s)[None, :]
    u_ones = cache.u_ones + v * (torch.dot(v, mask2) / s)
    m = cache.P.shape[1]
    count = i - cache.base_n              # pivots pending BEFORE this append
    P = cache.P
    P[:, count] = v / d
    if count + 1 >= m:
        # flush: one (N, m) @ (m, N) GEMM into Kinv, the diagonal cancel of
        # the m pending identity slots, the mirror refresh, and ay/u_ones
        # re-derived from the fresh Kinv so recurrence rounding never
        # outlives a flush window
        idx = torch.arange(gp.capacity, device=P.device)
        pend = ((idx >= cache.base_n) & (idx <= i)).to(P.dtype)
        Kinv = cache.Kinv
        Kinv.addmm_(P, P.T)
        Kinv.diagonal().sub_(pend)
        a = Kinv @ torch.cat([ym, mask2[:, None]], dim=1)
        if cache.Kinv_q is not None:
            cache.Kinv_q.copy_(Kinv)
        P.zero_()
        cache = cache.replace(base_n=i + 1, ay=a[:, :-1], u_ones=a[:, -1])
    else:
        cache = cache.replace(ay=ay, u_ones=u_ones)
    mean = prepare_mean(gp2.mean, gp2.y, mask2)
    mu_bar = mean(x_new[None, :])[0]      # constant-type means: (p,)
    alpha = cache.ay - cache.u_ones[:, None] * mu_bar[None, :]
    return gp2.replace(mean=mean, alpha=alpha), cache

