"""The port's kernel modules against the JAX package's Pallas kernels.

The same numpy inputs go through each reference Pallas kernel, run the way
the reference's own tests run it off the TPU (interpret mode), and through
the port's wrapper on CPU tensors, which takes the kernel's plain PyTorch
version.  The CUDA kernels themselves run only on the card, where
chip_smoke.py holds each against the same plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limbo_tpu.ops import chol as jchol
from limbo_tpu.ops import gram as jgram
from limbo_tpu.ops.gram_pallas import gram_pallas as j_gram_pallas
from limbo_tpu.ops.gram_pallas import gram_train_pallas as j_gram_train
from limbo_tpu.ops.trimv import _trimv_pallas as j_trimv_pallas
from limbo_tpu_torch.ops import chol, gram, gram_pallas, trimv

torch.set_num_threads(1)

FORMS = ["se", "matern32", "matern52"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("form", FORMS)
def test_gram_plain_matches_pallas(form):
    """gram tile, f32, ragged (300, 200) shape: |err| <= 2e-6 + 2e-5|ref|
    (the tolerance of tests/test_pallas_gram.py)."""
    rng = np.random.default_rng(0)
    X1 = rng.uniform(size=(300, 8)).astype(np.float32)
    X2 = rng.uniform(size=(200, 8)).astype(np.float32)
    want = j_gram_pallas(jnp.asarray(X1), jnp.asarray(X2),
                         jnp.float32(1.7), jnp.float32(2.3), form=form,
                         interpret=True)
    got = gram_pallas.gram_pallas(_t(X1), _t(X2), torch.tensor(1.7),
                                  torch.tensor(2.3), form)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("form", FORMS)
def test_gram_train_plain_matches_pallas(form):
    """Padded training tile, f32, N = 320 with n = 200 valid rows:
    |err| <= 2e-6 + 2e-5|ref|, and the padding is exactly the identity."""
    rng = np.random.default_rng(1)
    N, n = 320, 200
    X = rng.uniform(size=(N, 5)).astype(np.float32)
    X[n:] = 0.0
    want = j_gram_train(jnp.asarray(X), jnp.float32(1.3), jnp.float32(0.7),
                        jnp.float32(0.01), jnp.float32(n), form=form,
                        interpret=True)
    got = gram_pallas.gram_train_pallas(_t(X), torch.tensor(1.3),
                                        torch.tensor(0.7), torch.tensor(0.01),
                                        n, form)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_array_equal(got[n:, n:].numpy(),
                                  np.eye(N - n, dtype=np.float32))


@pytest.mark.parametrize("transpose", [False, True])
def test_trimv_plain_matches_pallas(transpose):
    """Triangle matvec on the cache's Linv layout (N = 512, n = 300 valid,
    identity padding), f32: |err| <= 1e-5 max|ref|."""
    rng = np.random.default_rng(2)
    n, N = 300, 512
    A = np.tril(rng.standard_normal((n, n))) + 5.0 * np.eye(n)
    Linv = np.eye(N, dtype=np.float32)
    Linv[:n, :n] = np.linalg.inv(A).astype(np.float32)
    v = np.zeros(N, dtype=np.float32)
    v[:n] = rng.standard_normal(n)
    want = np.asarray(j_trimv_pallas(jnp.asarray(Linv), jnp.asarray(v),
                                     transpose, 256))
    got = trimv._trimv_pallas(_t(Linv), _t(v), transpose).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the dispatch (dense matvec below TRIMV_MIN_N) agrees too
    disp = trimv.trimv(_t(Linv), _t(v), transpose=transpose).numpy()
    np.testing.assert_allclose(disp, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _spd_factor(rng, n, dtype=np.float32):
    A = rng.standard_normal((n, n))
    K = A @ A.T / n + np.eye(n)
    return np.linalg.cholesky(K).astype(dtype)


@pytest.mark.parametrize("B", [64, 128])
def test_tri_inv_panel_plain_matches_pallas(B):
    """Inverse of one lower-triangular block, f32: |err| <= 1e-5 max|ref|
    (forward substitution in another order)."""
    rng = np.random.default_rng(3)
    Lii = _spd_factor(rng, B)
    want = np.asarray(jchol._tri_inv_panel(jnp.asarray(Lii)))
    got = chol._tri_inv_panel(_t(Lii), B)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_tri_inv_panel_all_blocks():
    """One call inverts every diagonal block (N = 256, B = 64)."""
    rng = np.random.default_rng(4)
    L = _spd_factor(rng, 256)
    got = chol._tri_inv_panel(_t(L), 64).numpy()
    for i in range(4):
        blk = L[64 * i:64 * (i + 1), 64 * i:64 * (i + 1)]
        np.testing.assert_allclose(got[i] @ blk, np.eye(64), atol=1e-4)


@pytest.mark.parametrize("B", [32, 64, 128, 256])
def test_tri_inv_panel_plain_upper_zero(B):
    """The plain version in the kernel's order (32-wide sub-inverses, then
    merges): every upper triangle is +0.0 bit for bit, also with NaN
    above the diagonal of L, which it does not read."""
    rng = np.random.default_rng(7)
    L = _spd_factor(rng, 2 * B)
    L[np.triu_indices(2 * B, 1)] = np.nan
    X = chol.tri_inv_panel_plain(_t(L), B)
    assert torch.isfinite(X).all()
    upper = torch.triu(torch.ones((B, B), dtype=torch.bool), 1)
    assert not X[:, upper].view(torch.int32).any()


@pytest.mark.parametrize("B", [16, 48, 96, 160])
def test_tri_inv_panel_plain_refuses_other_blocks(B):
    """Only a power-of-two multiple of the 32-wide sub-block is taken."""
    with pytest.raises(ValueError, match="power-of-two multiple of 32"):
        chol.tri_inv_panel_plain(torch.eye(2 * B), B)


def test_tri_inv_blocked_matches_reference():
    """Blocked inverse, f32, N = 500 (padded to the block on both sides):
    the port (B = 128) against the reference (B = 256, Pallas panels in
    interpret mode), |err| <= 1e-4 max|ref|."""
    rng = np.random.default_rng(5)
    L = _spd_factor(rng, 500)
    want = np.asarray(jchol.tri_inv_blocked(jnp.asarray(L)))
    got = chol.tri_inv_blocked(_t(L)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # the CPU dispatch takes the library solve and agrees as well
    np.testing.assert_allclose(chol.tri_inv(_t(L)).numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert chol.use_blocked_tri(10240, torch.device("cuda"))
    assert not chol.use_blocked_tri(10240, torch.device("cpu"))


@pytest.mark.parametrize("form", FORMS)
def test_gram_fast_backward_matches_jax_vjp(form):
    """The fused forward's autograd backward (recompute through the
    reference form) against jax.vjp of the reference form, f64, 1e-10."""
    rng = np.random.default_rng(6)
    X1 = rng.uniform(size=(7, 3))
    X2 = rng.uniform(size=(5, 3))
    g = rng.standard_normal((7, 5))
    sf2, inv_l = 1.4, 1.9
    ref = {"se": lambda a, b, s, il: jgram.se_gram_ref(a, b, s),
           "matern32": jgram.matern32_gram_ref,
           "matern52": jgram.matern52_gram_ref}[form]
    want_out, vjp = jax.vjp(ref, jnp.asarray(X1), jnp.asarray(X2),
                            jnp.float64(sf2), jnp.float64(inv_l))
    want = vjp(jnp.asarray(g))
    ins = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
           for a in (X1, X2, sf2, inv_l)]
    out = gram._GramFast.apply(*ins, form)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-12, atol=1e-12)
    out.backward(torch.from_numpy(g))
    for i, (t, w) in enumerate(zip(ins, want)):
        if form == "se" and i == 3:
            assert t.grad is None              # inv_l unused in the se form
            continue
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-10, atol=1e-10)


def test_train_fast_backward_matches_jax_vjp():
    """The fused training covariance's backward against jax.vjp of the
    reference assembly (matern52, N = 9 with n = 6), f64, 1e-10."""
    rng = np.random.default_rng(7)
    X = rng.uniform(size=(9, 2))
    g = rng.standard_normal((9, 9))
    n = 6
    f = lambda a, b, c, d: jgram.matern52_train_ref(a, b, c, d,
                                                    jnp.float64(n))
    _, vjp = jax.vjp(f, jnp.asarray(X), jnp.float64(1.2), jnp.float64(0.8),
                     jnp.float64(0.01))
    want = vjp(jnp.asarray(g))
    ins = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
           for a in (X, 1.2, 0.8, 0.01)]
    out = gram._TrainFast.apply(*ins, n, "matern52")
    out.backward(torch.from_numpy(g))
    for t, w in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10)
