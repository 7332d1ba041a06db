"""Exact and Monte Carlo Expected Hypervolume Improvement (port of
limbo_tpu/ops/ehvi.py).

Reference capability: src/ehvi/ehvi_calculations.cc (Hupkens et al. exact
2-D / 3-D EHVI, called through limbo's experimental EHVI acquisition,
experimental/acqui/ehvi.hpp:59), 2,137 lines of scalar C++.

The exact 2-D EHVI is a closed-form stripe decomposition, O(k) a candidate
after one sort of the front; 3-D (and 2-D through the same path) sums
separable per-objective factors over a box decomposition of the
non-dominated region.  Every function takes candidates with any leading
batch axes, mu and sigma (..., p), so the whole seed batch of an ascent is
one evaluation, and is differentiable under torch.autograd (the ascent
climbs its gradient).  Sorts are stable, as jnp.argsort is, so padded and
tied fronts decompose as the reference's do.

Derivation (minimization form; maximization negates): with the front sorted
ascending in objective 1 as (a_i, b_i), b descending, sentinels a_0 = -inf,
b_0 = r2, a_{k+1} = r1, and the one-dimensional integral
    psi(b, mu, s) = E[(b - Y)^+] = s*phi((b-mu)/s) + (b-mu)*Phi((b-mu)/s),
the improvement of y in stripe i ( a_{i-1} <= y1 < a_i ) is
    (a_i - y1)(b_{i-1} - y2)^+  +  sum_{j>i} (a_j - a_{j-1})(b_{j-1} - y2)^+,
so integrating the independent Gaussians stripe by stripe:
    EHVI = sum_{i=1}^{k+1}  [psi1(a_i) - psi1(a_i; trunc a_{i-1})] psi2(b_{i-1})
         + [Phi1(a_i) - Phi1(a_{i-1})] * suffix_i,
    suffix_i = sum_{j=i+1}^{k+1} (a_j - a_{j-1}) psi2(b_{j-1}).
(psi1(a; trunc t) = s1*phi((t-mu1)/s1) + (a-mu1)*Phi((t-mu1)/s1).)
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np
import torch

_SQRT2 = math.sqrt(2.0)
BIG = 1e30


def _phi(z):
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _Phi(z):
    return 0.5 * torch.special.erfc(-z / _SQRT2)


def _psi(b, trunc, mu, s):
    """integral_{-inf}^{trunc} (b - y) N(y; mu, s^2) dy."""
    z = (trunc - mu) / s
    return s * _phi(z) + (b - mu) * _Phi(z)


def _relu(x):
    """max(x, 0) with jnp.maximum's gradient (half of it at a tie)."""
    return torch.maximum(x, torch.zeros_like(x))


def _prod(factors):
    """The product of a short sequence of tensors (one per objective), as
    a chain of multiplies.  torch.prod over the objective axis would do
    the same in the forward, but its backward, where a factor can be 0,
    is a cumulative-product scan over that axis of 2 or 3, which took 72%
    of the 3-objective ascent's device time on an H100 (PERF.md, the mo
    path's profile)."""
    out = factors[0]
    for f in factors[1:]:
        out = out * f
    return out


def _clip_front(front, ref, front_mask):
    """Padded rows moved to ref, then every row clipped into the ref box
    (padded rows land in zero-width stripes or cells)."""
    f = front
    if front_mask is not None:
        f = torch.where(front_mask[:, None] > 0, f, ref[None, :])
    return torch.minimum(f, ref[None, :])


def _as(ref, like):
    return torch.as_tensor(ref, dtype=like.dtype, device=like.device)


def ehvi_2d_min(mu: torch.Tensor, sigma: torch.Tensor, front: torch.Tensor,
                ref: torch.Tensor, front_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Exact EHVI, MINIMIZATION convention.

    mu, sigma: (..., 2) predictive moments.  front: (k, 2) mutually
    non-dominated points (padding allowed with front_mask: padded rows are
    clamped to the reference point, which contributes zero).  ref: (2,),
    worse than every front point.  Returns (...)."""
    ref = _as(ref, front)
    f = _clip_front(front, ref, front_mask)
    order = torch.argsort(f[:, 0], stable=True)
    a = f[order, 0]                                   # ascending obj 1
    # the staircase, against padding artefacts: running min of b
    b = torch.cummin(f[order, 1], dim=0).values
    big = torch.full((1,), BIG, dtype=f.dtype, device=f.device)
    a_aug = torch.cat([-big, a, ref[0:1]])            # a_0 .. a_{k+1}
    b_aug = torch.cat([ref[1:2], b])                  # b_0 .. b_k
    mu1, mu2 = mu[..., 0:1], mu[..., 1:2]
    s1 = torch.clamp(sigma[..., 0:1], min=1e-12)
    s2 = torch.clamp(sigma[..., 1:2], min=1e-12)

    psi2 = _psi(b_aug, b_aug, mu2, s2)                # (..., k+1)
    a_hi, a_lo = a_aug[1:], a_aug[:-1]
    width = a_hi - a_lo
    # stripe 1's width is infinite; only j >= 2 enter the suffix sums
    terms = width * psi2
    terms = torch.cat([torch.zeros_like(terms[..., :1]), terms[..., 1:]],
                      dim=-1)
    suffix = torch.flip(torch.cumsum(torch.flip(terms, [-1]), dim=-1), [-1])
    suffix_excl = torch.cat([suffix[..., 1:],
                             torch.zeros_like(suffix[..., :1])], dim=-1)

    psi1_full = _psi(a_hi, a_hi, mu1, s1)
    psi1_trunc = _psi(a_hi, a_lo, mu1, s1)
    cdf_hi = _Phi((a_hi - mu1) / s1)
    cdf_lo = _Phi((a_lo - mu1) / s1)
    contrib = ((psi1_full - psi1_trunc) * psi2
               + (cdf_hi - cdf_lo) * suffix_excl)
    return torch.sum(contrib, dim=-1)


def ehvi_2d_max(mu, sigma, front, ref, front_mask=None) -> torch.Tensor:
    """EHVI under MAXIMIZATION (limbo's BO convention): negate and reuse."""
    return ehvi_2d_min(-mu, sigma, -front, -_as(ref, front),
                       front_mask=front_mask)


def _psi_interval(l, u, mu, s):
    """E[(u - max(y, l))^+] for y ~ N(mu, s^2), u >= l:
      (u - l) Phi(z_l) + (u - mu)(Phi(z_u) - Phi(z_l)) + s (phi(z_u) - phi(z_l))
    with z_t = (t - mu)/s.  l = -inf gives the classic E[(u - y)^+]."""
    l_c = torch.clamp(l, min=-BIG)          # (u - l) finite; Phi(z_l) = 0
    z_l = (l_c - mu) / s
    z_u = (u - mu) / s
    return ((u - l_c) * _Phi(z_l)
            + (u - mu) * (_Phi(z_u) - _Phi(z_l))
            + s * (_phi(z_u) - _phi(z_l)))


def nondominated_boxes_3d(front: torch.Tensor, ref: torch.Tensor,
                          front_mask: Optional[torch.Tensor] = None):
    """Partition the non-dominated region below ``ref`` into (k+1)^2 boxes
    (MINIMIZATION).  Returns (lower, upper), ((k+1)^2, 3) each; lower is
    -1e30 where a box is unbounded below.

    The xy-plane is gridded at the front's x / y coordinates (and sentinels
    at -inf and ref); the z-column over cell (i, j) is non-dominated exactly
    below zeta_ij = min{ p_z : p_x <= x_i, p_y <= y_j } (else ref_z), one
    (k+1, k+1, k) comparison tensor."""
    k = front.shape[0]
    ref = _as(ref, front)
    f = _clip_front(front, ref, front_mask)
    big = torch.full((1,), BIG, dtype=f.dtype, device=f.device)
    xs = torch.sort(f[:, 0]).values
    ys = torch.sort(f[:, 1]).values
    ex = torch.cat([-big, xs, ref[0:1]])                          # (k+2,)
    ey = torch.cat([-big, ys, ref[1:2]])
    dom_x = f[None, :, 0] <= ex[:k + 1, None]                     # (k+1, k)
    dom_y = f[None, :, 1] <= ey[:k + 1, None]
    cond = dom_x[:, None, :] & dom_y[None, :, :]                  # (k+1)^2 k
    zeta = torch.amin(torch.where(cond, f[None, None, :, 2], big), dim=-1)
    z_hi = torch.minimum(zeta, ref[2])                            # (k+1)^2

    shape = (k + 1, k + 1)
    lx = ex[:k + 1, None].expand(shape)
    ux = ex[1:, None].expand(shape)
    ly = ey[None, :k + 1].expand(shape)
    uy = ey[None, 1:].expand(shape)
    lz = torch.full(shape, -BIG, dtype=f.dtype, device=f.device)
    lower = torch.stack([lx, ly, lz], dim=-1).reshape(-1, 3)
    upper = torch.stack([ux, uy, z_hi], dim=-1).reshape(-1, 3)
    return lower, upper


def nondominated_boxes_2d(front: torch.Tensor, ref: torch.Tensor,
                          front_mask: Optional[torch.Tensor] = None):
    """Stripe decomposition of the 2-D non-dominated region (k+1 boxes)."""
    ref = _as(ref, front)
    f = _clip_front(front, ref, front_mask)
    big = torch.full((1,), BIG, dtype=f.dtype, device=f.device)
    order = torch.argsort(f[:, 0], stable=True)
    a = f[order, 0]
    b = torch.cummin(f[order, 1], dim=0).values
    ex = torch.cat([-big, a, ref[0:1]])                           # (k+2,)
    b_hi = torch.cat([ref[1:2], b])                               # (k+1,)
    lower = torch.stack([ex[:-1], torch.full_like(b_hi, -BIG)], dim=-1)
    upper = torch.stack([ex[1:], b_hi], dim=-1)
    return lower, upper


def nondominated_boxes(front, ref, front_mask=None):
    p = front.shape[1]
    if p == 2:
        return nondominated_boxes_2d(front, ref, front_mask)
    if p == 3:
        return nondominated_boxes_3d(front, ref, front_mask)
    raise NotImplementedError(
        f"exact box decomposition needs p in (2, 3), got {p}")


def ehvi_boxes_min(mu: torch.Tensor, sigma: torch.Tensor,
                   lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Exact EHVI from a box decomposition (MINIMIZATION):
        EHVI = sum_boxes prod_m psi(l_m, u_m, mu_m, sigma_m),
    separable because the objectives' marginals are independent (one GP
    per objective, limbo bo_multi.hpp:153).  mu, sigma (..., p) -> (...)."""
    s = torch.clamp(sigma, min=1e-12)
    factors = _psi_interval(lower, upper, mu[..., None, :], s[..., None, :])
    return torch.sum(_prod(_relu(factors).unbind(-1)), dim=-1)


def ehvi_3d_min(mu, sigma, front, ref, front_mask=None) -> torch.Tensor:
    """Exact 3-D EHVI, minimization (the capability of
    src/ehvi/ehvi_sliceupdate.cc, as O(k^2) cells)."""
    lower, upper = nondominated_boxes_3d(front, ref, front_mask)
    return ehvi_boxes_min(mu, sigma, lower, upper)


def ehvi_3d_max(mu, sigma, front, ref, front_mask=None) -> torch.Tensor:
    """3-D EHVI under MAXIMIZATION (limbo's BO convention)."""
    return ehvi_3d_min(-mu, sigma, -front, -_as(ref, front),
                       front_mask=front_mask)


def ehvi_max(mu, sigma, front, ref, front_mask=None) -> torch.Tensor:
    """Exact EHVI (maximization), p = 2 or 3, by box decomposition."""
    lower, upper = nondominated_boxes(-front, -_as(ref, front), front_mask)
    return ehvi_boxes_min(-mu, sigma, lower, upper)


def ehvi_max_batch(mus, sigmas, front, ref, front_mask=None) -> torch.Tensor:
    """Exact EHVI of a whole candidate population (maximization), one box
    decomposition shared by all (the capability of
    src/ehvi/ehvi_multi.cc:13,100).  mus, sigmas: (q, p) -> (q,)."""
    return ehvi_max(mus, sigmas, front, ref, front_mask)


def _gh_grid(r: int, n_nodes: int, dtype, device):
    """Tensor Gauss-Hermite grid for r standard-normal dimensions: eps
    (n_nodes^r, r) and weights (n_nodes^r,) summing to 1 (NumPy's nodes)."""
    x, w = np.polynomial.hermite.hermgauss(n_nodes)
    kw = dict(dtype=dtype, device=device)
    eps1 = torch.as_tensor(x * math.sqrt(2.0), **kw)          # N(0,1) nodes
    w1 = torch.as_tensor(w / math.sqrt(math.pi), **kw)
    eps = torch.stack(torch.meshgrid(*([eps1] * r), indexing="ij"),
                      dim=-1).reshape(-1, r)
    wts = torch.prod(torch.stack(torch.meshgrid(*([w1] * r), indexing="ij"),
                                 dim=-1).reshape(-1, r), dim=-1)
    return eps, wts


def _g_max_interval(l, u, mu_S, cov_S, gh_nodes: int):
    """E[(u - max(l, max_j z_j))^+] for z_S ~ N(mu_S, cov_S), over box
    bounds l, u (nb,) and leading batch axes of mu_S (..., r) and cov_S
    (..., r, r); returns (..., nb).

    |S| = 1 is the closed form ``_psi_interval``; |S| >= 2 conditions the
    last variable on the first |S|-1 through the covariance's Cholesky
    factor (cholesky_ex: no wait on the card) and integrates them with
    tensor Gauss-Hermite."""
    r = mu_S.shape[-1]
    if r == 1:
        return _psi_interval(l, u, mu_S, torch.sqrt(cov_S[..., 0]))
    eye = torch.eye(r, dtype=cov_S.dtype, device=cov_S.device)
    tr = torch.diagonal(cov_S, dim1=-2, dim2=-1).sum(-1)
    C = torch.linalg.cholesky_ex(cov_S + 1e-10 * tr[..., None, None]
                                 * eye).L
    eps, w = _gh_grid(r - 1, gh_nodes, mu_S.dtype, mu_S.device)
    z_head = mu_S[..., None, :r - 1] + eps @ C[..., :r - 1, :r - 1].mT
    z_max = torch.amax(z_head, dim=-1)                           # (..., G)
    m_cond = mu_S[..., r - 1:r] + (eps @ C[..., r - 1, :r - 1, None]
                                   )[..., 0]                     # (..., G)
    s_cond = torch.clamp(C[..., r - 1, r - 1], min=1e-12)
    a = torch.minimum(torch.maximum(l[:, None], z_max[..., None, :]),
                      u[:, None])                                # (..., nb, G)
    vals = _psi_interval(a, u[:, None], m_cond[..., None, :],
                         s_cond[..., None, None])
    return torch.sum(w * vals, dim=-1)


def qehvi_exact_max(mu: torch.Tensor, cov: torch.Tensor, front: torch.Tensor,
                    ref, front_mask: Optional[torch.Tensor] = None,
                    gh_nodes: int = 24) -> torch.Tensor:
    """Exact joint q-EHVI (maximization): the expected hypervolume
    improvement of a q-candidate batch under its JOINT Gaussian posterior.

    mu: (..., q, p) posterior means; cov: (..., p, q, q) each objective's
    joint covariance of the q candidates (objectives independent; see
    acqui.qei.joint_posterior_multi).  Inclusion-exclusion over candidate
    subsets S on the shared box decomposition: per box and objective the
    subset factor is E[(u_m - max(l_m, max_{j in S} z_jm))^+], closed form
    for |S| = 1 and Gauss-Hermite-conditioned for |S| >= 2.  2^q - 1
    subsets and gh_nodes^(|S|-1) nodes: meant for q <= 4 (Python loops
    over the subsets); ``qehvi_mc_max`` for larger q."""
    q, p = mu.shape[-2], mu.shape[-1]
    lower, upper = nondominated_boxes(-front, -_as(ref, front), front_mask)
    mu_min = -mu
    total = torch.zeros(mu.shape[:-2], dtype=mu.dtype, device=mu.device)
    for r in range(1, q + 1):
        sign = 1.0 if r % 2 == 1 else -1.0
        for S in itertools.combinations(range(q), r):
            idx = torch.tensor(S, device=mu.device)
            factors = []
            for m in range(p):
                mu_S = mu_min[..., idx, m]
                cov_S = cov[..., m, :, :][..., idx[:, None], idx[None, :]]
                g = _g_max_interval(lower[:, m], upper[:, m], mu_S, cov_S,
                                    gh_nodes)
                factors.append(_relu(g))
            total = total + sign * torch.sum(
                _prod(factors), dim=-1)
    return total


def qehvi_mc_max(Y_samples: torch.Tensor, front: torch.Tensor, ref,
                 front_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q-point batch EHVI by Monte Carlo over JOINT posterior samples (the
    capability of src/ehvi/ehvi_multi.cc's multi-point EHVI; the qEHVI
    inclusion-exclusion estimator).

    Y_samples: (n_mc, q, p) joint draws for the q candidates.  Per draw the
    union improvement is summed cell by cell with inclusion-exclusion over
    candidate subsets, exact for each sample.  p in (2, 3)."""
    n_mc, q, p = Y_samples.shape
    lower, upper = nondominated_boxes(-front, -_as(ref, front), front_mask)
    Z = -Y_samples
    total = torch.zeros((), dtype=Y_samples.dtype, device=Y_samples.device)
    for r in range(1, q + 1):
        sign = 1.0 if r % 2 == 1 else -1.0
        for S in itertools.combinations(range(q), r):
            zS = torch.amax(Z[:, list(S), :], dim=1)              # (n_mc, p)
            a = torch.maximum(zS[:, None, :], lower[None, :, :])
            vol = _prod(_relu(upper[None, :, :] - a).unbind(-1))
            total = total + sign * torch.sum(vol) / n_mc
    return total


def ehvi_mc_max(generator: torch.Generator, mu: torch.Tensor,
                sigma: torch.Tensor, front: torch.Tensor, ref,
                front_mask: Optional[torch.Tensor] = None,
                n_samples: int = 1024) -> torch.Tensor:
    """Monte Carlo EHVI for 2 or 3 objectives (maximization), batched over
    the samples (reference: src/ehvi/ehvi_montecarlo.cc); the normals come
    from ``generator`` (on mu's device)."""
    eps = torch.randn((n_samples, mu.shape[0]), generator=generator,
                      dtype=mu.dtype, device=mu.device)
    return _ehvi_mc(mu[None, :] + sigma[None, :] * eps, front, ref,
                    front_mask)


def _ehvi_mc(ys: torch.Tensor, front: torch.Tensor, ref,
             front_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ehvi_mc_max given its samples ys (n_samples, p)."""
    from limbo_tpu_torch.ops.pareto import hypervolume_2d

    p = ys.shape[1]
    ref = _as(ref, front)
    mask = (front_mask.to(front.dtype) if front_mask is not None
            else torch.ones(front.shape[0], dtype=front.dtype,
                            device=front.device))
    if p == 2:
        hv0 = hypervolume_2d(front, ref, mask)
        S = ys.shape[0]
        F = torch.cat([front.expand(S, -1, -1), ys[:, None, :]], dim=1)
        m = torch.cat([mask.expand(S, -1),
                       torch.ones((S, 1), dtype=mask.dtype,
                                  device=mask.device)], dim=1)
        hvs = hypervolume_2d(F, ref, m)
        return torch.mean(_relu(hvs - hv0))
    if p == 3:
        # per-sample improvement is exact through the box decomposition
        return qehvi_mc_max(ys[:, None, :], front, ref, front_mask=front_mask)
    raise NotImplementedError("MC EHVI for p > 3 runs through "
                              "native.ehvi_mc_host")
