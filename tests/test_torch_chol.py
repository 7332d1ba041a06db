"""The port's blocked Cholesky, its panel factor and its pullback against
the JAX package's.

The reference's Pallas panel kernel runs in interpret mode on the CPU, as
tests/test_chol.py runs it; the port's wrappers take their plain versions
on CPU tensors.  The CUDA kernels are held to the same plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limbo_tpu.ops import chol as jchol
from limbo_tpu_torch.ops import chol

torch.set_num_threads(1)

# The reference's pullback jitted: one program instead of one compile per
# primitive.  The blocked factorizations stay eager: their unrolled loop
# reuses one compiled panel, where a jitted program inlines every panel.

@jax.jit
def _jvjp_blocked(a, lbar):
    L, vjp = jax.vjp(lambda m: jchol.cholesky(m, 64, 0), a)
    return L, vjp(lbar)[0]


@jax.jit
def _jvjp_stock(a, lbar):
    L, vjp = jax.vjp(lambda m: jchol.cholesky(m, 64, None), a)
    return L, vjp(lbar)[0]


def _spd(rng, n, dtype=np.float64, jitter=1.0):
    A = rng.standard_normal((n, n))
    return (A @ A.T / n + jitter * np.eye(n)).astype(dtype)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_panel_factor_plain_matches_pallas():
    """One (64, 64) block, f32: L11 and L11^{-T} within 64 * 2^-24 * 8 of
    max|ref| (two factorization orders, each off by ~B u)."""
    rng = np.random.default_rng(0)
    D = _spd(rng, 64, np.float32)
    want_l, want_v = (np.asarray(a) for a in
                      jchol._panel_factor_pallas(jnp.asarray(D)))
    got_l, got_v = chol._panel_factor_pallas(_t(D))
    tol = 8 * 64 * 2.0 ** -24
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0,
                               atol=tol * np.abs(want_l).max())
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0,
                               atol=tol * np.abs(want_v).max())
    assert np.all(np.triu(got_l.numpy(), 1) == 0.0)
    assert np.all(np.tril(got_v.numpy(), -1) == 0.0)
    # panel_factor returns (L11, L11^{-1}), as the reference's does
    l11, l11inv = chol.panel_factor(_t(D))
    np.testing.assert_allclose((l11inv @ l11).numpy(), np.eye(64), atol=1e-5)


@pytest.mark.parametrize("n", [200, 256])
def test_cholesky_blocked_matches_reference(n):
    """Blocked factor at block 64, f32 (200 is padded to 256 with an
    identity block): |err| <= 4 n 2^-24 max|L|, the rounding of two
    factorizations in different orders of a matrix with condition < 5."""
    rng = np.random.default_rng(n)
    K = _spd(rng, n, np.float32)
    want = np.asarray(jchol.cholesky_blocked(jnp.asarray(K), block=64))
    got = chol.cholesky_blocked(_t(K), block=64)
    assert got.shape == (n, n)
    tol = 4 * n * 2.0 ** -24 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # the dispatch takes the same path when min_blocked forces it
    forced = chol.cholesky(_t(K), block=64, min_blocked=0)
    np.testing.assert_allclose(forced.numpy(), want, rtol=0, atol=tol)
    assert chol.use_blocked(n, "cpu", torch.float32, min_blocked=0)
    assert not chol.use_blocked(n, "cpu", torch.float32)
    assert chol.use_blocked(16896, "cuda", torch.float32)
    assert not chol.use_blocked(16896, "cuda", torch.float64)
    assert not chol.use_blocked(12287, "cuda", torch.float32)


@pytest.mark.parametrize("min_blocked", [0, None])
def test_cholesky_pullback_matches_jax_vjp(min_blocked):
    """The backward of cholesky(A, block=64, min_blocked) against jax.vjp of
    the reference's cholesky(A, 64, min_blocked), f64, N = 128 (two block
    columns): |err| <= 1e-10 max|ref|.  min_blocked=None is the stock-size
    path."""
    rng = np.random.default_rng(3)
    A = _spd(rng, 128)
    Lbar = rng.standard_normal((128, 128))
    fn = _jvjp_stock if min_blocked is None else _jvjp_blocked
    L_j, want = fn(jnp.asarray(A), jnp.asarray(Lbar))
    At = _t(A).requires_grad_(True)
    L = chol.cholesky(At, block=64, min_blocked=min_blocked)
    np.testing.assert_allclose(L.detach().numpy(), np.asarray(L_j), rtol=0,
                               atol=1e-12)
    L.backward(_t(Lbar))
    want = np.asarray(want)
    np.testing.assert_allclose(At.grad.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_blocked_nan_on_indefinite():
    """An indefinite input gives NaN through the blocked path, from the
    block of the failed pivot on (its GEMMs carry it into every later
    panel), as the reference's does; earlier blocks stay finite."""
    rng = np.random.default_rng(4)
    K = _spd(rng, 192, np.float32)
    K[130, 130] = -1.0                              # in the third block
    got = chol.cholesky(_t(K), block=64, min_blocked=0).numpy()
    want = np.asarray(jchol.cholesky(jnp.asarray(K), 64, 0))
    for L in (got, want):
        assert np.isnan(L[128:, 128:]).any()
        assert np.isfinite(L[:128, :128]).all()
        assert np.isnan(L[-1, -1])


def test_recompute_retries_a_partly_nan_blocked_factor(monkeypatch):
    """recompute's jitter-escalation retry fires when the blocked factor
    comes back partly NaN, f64, capacity 128 in blocks of 64.  The training
    covariance is lowered at entry (100, 100) until its least eigenvalue is
    -1e-5, inside the retry's ridge 32 eps_eff N max|diag K| (~4e-5): the
    leading 100 x 100 minor stays definite, so the first factor is finite
    in block 0 and NaN from block 1 on, and the second is finite and
    factors K + ridge * I."""
    from limbo_tpu_torch import kernels, means
    from limbo_tpu_torch.models import gp as tgp

    factors = []

    def blocked(A):
        L = chol.cholesky(A, block=64, min_blocked=0)
        factors.append(L)
        return L

    monkeypatch.setattr(tgp, "cholesky", blocked)
    rng = np.random.default_rng(6)
    X, Y = rng.uniform(size=(128, 2)), rng.standard_normal((128, 1))
    k = kernels.SquaredExpARD.create(dim=2, device="cpu",
                                     dtype=torch.float64)
    K0 = k.gram_train_masked(_t(X), 128)
    # lambda_min(K0 - b e e^T) = -1e-5 for b = 1 / [(K0 + 1e-5 I)^-1]_jj
    eye = torch.eye(128, dtype=torch.float64)
    bump = torch.zeros_like(K0)
    bump[100, 100] = 1.0 / torch.linalg.inv(K0 + 1e-5 * eye)[100, 100]
    k.gram_train_masked = lambda x, n, extra_jitter=None: K0 - bump
    gp = tgp.fit(k, means.DataMean.create(device="cpu", dtype=torch.float64),
                 X, Y, capacity=128, device="cpu")
    assert len(factors) == 2
    first = factors[0]
    assert torch.isfinite(first[:64, :64]).all()
    assert torch.isnan(first[64:, 64:]).any()
    assert torch.isfinite(gp.L).all() and torch.isfinite(gp.alpha).all()
    ridge = 32 * 1e-8 * 128 * float((K0 - bump).diagonal().abs().max())
    want = K0 - bump + ridge * eye
    torch.testing.assert_close(gp.L @ gp.L.T, want, rtol=0, atol=1e-12)
