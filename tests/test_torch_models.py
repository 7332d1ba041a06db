"""The other model families against the JAX package's: the iterative (CG)
GP, SPGP, SparsifiedGP and MultiGP (with ParallelLFOpt), and the model
dispatch.

The reference's own test sizes (tests/test_models_extra.py) and inputs
made from a seed with NumPy, in f64 (tests/conftest.py enables x64 for
the reference).  Where the reference draws (SPGP's pseudo-inputs, the
hp-opt restarts), the port is handed the reference's draws.  Tolerances:
1e-9 of the largest entry for direct computations (the two libraries sum
in other orders); CG results to 1e-9 as well, since both run the same
iterations to the same stopping test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limbo_tpu.kernels as jk
import limbo_tpu.means as jm
from limbo_tpu.models import gp as jgp
from limbo_tpu.models import iterative as jit_
from limbo_tpu.models import multi_gp as jmulti
from limbo_tpu.models import sparse_gp as jsparse
from limbo_tpu.models import spgp as jspgp
from limbo_tpu.models.hp_opt import KernelLFOpt as JKernelLFOpt
from limbo_tpu.opt import Rprop as JRprop
from limbo_tpu_torch import kernels, means
from limbo_tpu_torch.models import (dispatch, gp as tgp, iterative, multi_gp,
                                    sparse_gp, spgp)
from limbo_tpu_torch.models.hp_opt import KernelLFOpt
from limbo_tpu_torch.opt import Rprop

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
# the reference's entry points jitted: one compile instead of one per
# primitive in eager mode, which keeps these tests inside their budget
_jq = {m: jax.jit(m.query) for m in (jit_, jspgp, jmulti)}
_jspgp_fit = jax.jit(jspgp.fit, static_argnames=("m",))


def _close(got, want, rel=1e-9):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _exp(l=0.3):
    return (jk.Exp.create(l=l, dtype=jnp.float64),
            kernels.Exp.create(l=l, **F64))


# ---------------------------------------------------------------------------
# iterative (CG)
# ---------------------------------------------------------------------------

def _data(rng, n, d, p=1):
    X = rng.uniform(size=(n, d))
    Y = np.sin(3 * X.sum(1, keepdims=True)) + 0.1 * rng.normal(size=(n, p))
    return X, Y


def test_cg_solve_value_and_backward_equal_reference():
    """cg_solve on an SPD blocked kernel matvec (40 points, block 16, four
    right-hand sides): X and the residual norms, then the gradient of
    sum(w * X) w.r.t. B (one more CG solve) against the reference's
    custom_vjp.  The kernel gets no gradient."""
    rng = np.random.default_rng(0)
    X, _ = _data(rng, 40, 2)
    B = rng.normal(size=(40, 4))
    w = rng.normal(size=(40, 4))
    kj, kt = _exp()
    mask = np.ones(40)

    def jmv(V):
        return jit_.blocked_kernel_matvec(kj, jnp.asarray(X),
                                          jnp.asarray(mask), 0.01, V, 16)

    def tmv(V):
        return iterative.blocked_kernel_matvec(kt, _t(X), _t(mask), 0.01, V,
                                               16)

    Xj, rj = jax.jit(lambda b: jit_.cg_solve(jmv, b, 1e-10, 200))(
        jnp.asarray(B))
    gj = jax.jit(jax.grad(lambda b: jnp.sum(jnp.asarray(w) * jit_.cg_solve(
        jmv, b, 1e-10, 200)[0])))(jnp.asarray(B))
    Bt = _t(B).requires_grad_(True)
    kt.log_l.requires_grad_(True)
    Xt, rt = iterative.cg_solve(tmv, Bt, 1e-10, 200)
    assert not rt.requires_grad
    (gt,) = torch.autograd.grad(torch.sum(_t(w) * Xt), Bt)
    _close(Xt, Xj)
    _close(rt, rj, rel=1e-6)
    _close(gt, gj)
    assert kt.log_l.grad is None
    # the solve itself: K X = B
    _close(tmv(Xt.detach()), B, rel=1e-8)
    # a maxiter cut below convergence stops where the reference stops
    Xj3, _ = jax.jit(lambda b: jit_.cg_solve(jmv, b, 1e-10, 3))(
        jnp.asarray(B))
    Xt3, _ = iterative.cg_solve(tmv, _t(B), 1e-10, 3)
    _close(Xt3, Xj3)


def test_iterative_fit_query_refit_equal_reference():
    """fit with a DataMean (capacity 64, block 16), query with variance,
    then an append (stale alpha, as the reference) and refit, against the
    reference; and the fit against the exact GP to 1e-6
    (tests/test_models_extra.py:170-200)."""
    rng = np.random.default_rng(1)
    X, Y = _data(rng, 40, 2)
    Y = Y + 5.0
    kj, kt = _exp()
    mj_ = jm.DataMean.create(dtype=jnp.float64)
    mt_ = means.DataMean.create(**F64)
    kw = dict(capacity=64, block=16, cg_tol=1e-10, cg_maxiter=500)
    ij = jax.jit(lambda k, m, x, y: jit_.fit(k, m, x, y, **kw))(
        kj, mj_, jnp.asarray(X), jnp.asarray(Y))
    it = iterative.fit(kt, mt_, _t(X), _t(Y), device="cpu", **kw)
    Xq = rng.uniform(size=(10, 2))
    for a, b in zip(iterative.query(it, _t(Xq)),
                    _jq[jit_](ij, jnp.asarray(Xq))):
        _close(a, b)
    assert int(it.cg_iters) > 0 and float(it.cg_residual.max()) < 1e-8
    exact = tgp.fit(kt, mt_, _t(X), _t(Y), capacity=64, device="cpu")
    for a, b in zip(iterative.query(it, _t(Xq)), tgp.query(exact, _t(Xq))):
        _close(a, b.numpy(), rel=1e-6)
    xn, yn = rng.uniform(size=2), rng.normal(size=1)
    ij = jax.jit(jit_.add_sample)(ij, jnp.asarray(xn), jnp.asarray(yn))
    it = iterative.add_sample(it, _t(xn), _t(yn))
    assert it.n == int(ij.n) == 41
    _close(it.alpha, ij.alpha)                      # stale until refit
    ij, it = jax.jit(jit_.refit)(ij), iterative.refit(it)
    _close(it.alpha, ij.alpha)
    for a, b in zip(dispatch.query_any(it, _t(Xq)),
                    _jq[jit_](ij, jnp.asarray(Xq))):
        _close(a, b)
    e = iterative.empty(kt, mt_, 2, capacity=64, block=2048, device="cpu")
    assert e.block == 64 and e.n == 0


# ---------------------------------------------------------------------------
# SPGP
# ---------------------------------------------------------------------------

def _spgp_pair(n=20, d=2, m=5):
    rng = np.random.default_rng(2)
    X = rng.uniform(size=(n, d))
    Y = rng.normal(size=(n, 1))
    kj = jk.SquaredExpARD.create(dim=d, noise=0.05, dtype=jnp.float64)
    kt = kernels.SquaredExpARD.create(dim=d, noise=0.05, **F64)
    sj = _jspgp_fit(kj, jm.DataMean.create(dtype=jnp.float64),
                    jnp.asarray(X), jnp.asarray(Y), m=m,
                    key=jax.random.PRNGKey(3))
    st = spgp.fit(kt, means.DataMean.create(**F64), _t(X), _t(Y), m=m,
                  xb=_t(sj.xb), device="cpu")
    return sj, st, rng


def test_spgp_nlml_gradient_and_query_equal_reference():
    """The FITC NLML and its gradient in xb and the kernel parameters, and
    the predictive moments, on the reference's pseudo-inputs
    (tests/test_models_extra.py:150-167's size)."""
    sj, st, rng = _spgp_pair()
    assert st.x.shape == sj.x.shape and st.n == int(sj.n) == 20

    def jf(xb, p):
        return jspgp.neg_log_marginal_likelihood(
            sj.kernel.with_params(p), sj.mean, xb, sj.x, sj.y, sj.n)

    vj, (gxj, gpj) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        sj.xb, sj.kernel.params)
    xb = st.xb.clone().requires_grad_(True)
    p = st.kernel.params.clone().requires_grad_(True)
    vt = spgp.neg_log_marginal_likelihood(st.kernel.with_params(p), st.mean,
                                          xb, st.x, st.y, st.n)
    gxt, gpt = torch.autograd.grad(vt, (xb, p))
    _close(vt, vj)
    _close(gxt, gxj)
    _close(gpt, gpj)
    Xq = rng.uniform(size=(7, 2))
    for a, b in zip(dispatch.query_any(st, _t(Xq)),
                    _jq[jspgp](sj, jnp.asarray(Xq))):
        _close(a, b)
    # a failed factor is NaN, as jnp.linalg.cholesky's, not an exception:
    # two equal pseudo-inputs and a signal variance of e^40, beside which
    # the 1e-6 jitter rounds away, make Kmm singular
    bad = st.xb.clone()
    bad[1] = bad[0]
    v = spgp.neg_log_marginal_likelihood(
        st.kernel.with_params(torch.tensor([5.0, 5.0, 20.0],
                                           dtype=torch.float64)),
        st.mean, bad, st.x, st.y, st.n)
    assert np.isnan(float(v))


def test_spgp_hpopt_and_add_sample_equal_reference():
    """SPGPHpOpt(Rprop(10)) (deterministic) moves the pseudo-inputs and
    parameters as the reference's; then an append and a query."""
    sj, st, rng = _spgp_pair()
    sj2 = jax.jit(jspgp.SPGPHpOpt(optimizer=JRprop(iterations=10)))(
        sj, jax.random.PRNGKey(0))
    st2 = spgp.SPGPHpOpt(optimizer=Rprop(iterations=10))(st)
    _close(st2.xb, sj2.xb, rel=1e-8)
    _close(st2.kernel.params, sj2.kernel.params, rel=1e-8)
    xn, yn = rng.uniform(size=2), rng.normal(size=1)
    sj3 = jspgp.add_sample(sj2, jnp.asarray(xn), jnp.asarray(yn))
    st3 = spgp.add_sample(st2, _t(xn), _t(yn))
    assert st3.n == 21
    _close(st3.mean.value, sj3.mean.value)
    Xq = rng.uniform(size=(5, 2))
    for a, b in zip(spgp.query(st3, _t(Xq)),
                    _jq[jspgp](sj3, jnp.asarray(Xq))):
        _close(a, b, rel=1e-8)
    e = spgp.empty(st.kernel, st.mean, 2, m=4, capacity=32, device="cpu",
                   dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    assert e.xb.shape == (4, 2) and e.n == 0
    f = spgp.fit(st.kernel, st.mean, st.x[:20], st.y[:20], device="cpu",
                 generator=torch.Generator().manual_seed(0))
    assert f.m == 2 and len({tuple(r) for r in f.xb.tolist()}) == 2


# ---------------------------------------------------------------------------
# SparsifiedGP
# ---------------------------------------------------------------------------

def test_sparsify_keeps_the_reference_set_in_its_order():
    """Kept set and order (60 points to 30), the compacted buffers bit for
    bit, and the reference test's cluster + corners case (5 kept: the
    corners survive); then fit and an append that re-sparsifies."""
    rng = np.random.default_rng(4)
    X = rng.uniform(size=(64, 2))
    X[60:] = 0.0
    Y = rng.normal(size=(64, 1))
    Y[60:] = 0.0
    jsparsify = jax.jit(jsparse.sparsify, static_argnums=3)
    Xj, Yj, nj = jsparsify(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(60),
                           30)
    Xt, Yt, nt = sparse_gp.sparsify(_t(X), _t(Y), 60, 30)
    assert nt == int(nj) == 30
    np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))
    np.testing.assert_array_equal(Yt.numpy(), np.asarray(Yj))
    C = np.vstack([np.array([[0.5, 0.5]]) + 1e-3
                   * np.random.default_rng(0).normal(size=(10, 2)),
                   np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0],
                             [1.0, 1.0]])])
    Xt, _, _ = sparse_gp.sparsify(_t(C), torch.zeros((14, 1),
                                                     dtype=torch.float64),
                                  14, 5)
    for corner in ([0, 0], [1, 0], [0, 1], [1, 1]):
        assert np.min(np.abs(Xt[:5].numpy() - corner).sum(1)) < 1e-9
    kj, kt = _exp()
    sj = jax.jit(lambda x, y: jsparse.fit(kj, jm.NullMean(), x, y,
                                          max_points=20, capacity=64))(
        jnp.asarray(X[:20]), jnp.asarray(Y[:20]))
    st = sparse_gp.fit(kt, means.NullMean(), _t(X[:20]), _t(Y[:20]),
                       max_points=20, capacity=64, device="cpu")
    xn, yn = rng.uniform(size=2), rng.normal(size=1)
    sj = jax.jit(jsparse.add_sample)(sj, jnp.asarray(xn), jnp.asarray(yn))
    st = sparse_gp.add_sample(st, _t(xn), _t(yn))
    assert st.n == int(sj.gp.n) == 20 and int(st.n_dev) == 20
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(sj.gp.x))
    Xq = rng.uniform(size=(6, 2))
    for a, b in zip(dispatch.query_any(st, _t(Xq)),
                    jax.jit(jgp.query)(sj.gp, jnp.asarray(Xq))):
        _close(a, b)


# ---------------------------------------------------------------------------
# MultiGP
# ---------------------------------------------------------------------------

def test_multi_gp_equal_reference():
    """fit with a DataMean wrapper (15 points, 3 outputs) and query; each
    output bit for bit the fit of its own centered column (the chip path's
    check); an append and recompute against the reference's fit of all
    the data."""
    rng = np.random.default_rng(6)
    X = rng.uniform(size=(15, 2))
    Y = rng.normal(size=(15, 3)) + 5.0
    kj, kt = _exp()
    jfit = jax.jit(jmulti.fit, static_argnames=("capacity",))
    mj = jfit(kj, jm.DataMean.create(dim_out=3, dtype=jnp.float64),
              jnp.asarray(X), jnp.asarray(Y), capacity=32)
    mt = multi_gp.fit(kt, means.DataMean.create(dim_out=3, **F64), _t(X),
                      _t(Y), capacity=32, device="cpu")
    assert mt.dim_out == 3 and mt.n == 15 and mt.capacity == 32
    Xq = rng.uniform(size=(6, 2))
    for a, b in zip(dispatch.query_any(mt, _t(Xq)),
                    _jq[jmulti](mj, jnp.asarray(Xq))):
        assert a.shape == (6, 3)
        _close(a, b)
    for g in mt.gps:
        f = tgp.fit(kt, means.NullMean(), _t(X), g.y[:15], capacity=32,
                    device="cpu")
        assert torch.equal(f.L, g.L) and torch.equal(f.alpha, g.alpha)
    # an append, then recompute (DataMean wrapper): the reference's fit of
    # all the data.  (The reference's own recompute(update_obs_mean=True)
    # and observations_padded index its stacked GP's mask and fail,
    # ROADMAP.md queue 3.)
    xn, yn = rng.uniform(size=2), rng.normal(size=3)
    mt = multi_gp.recompute(dispatch.add_sample_any(mt, _t(xn), _t(yn)))
    mj = jfit(kj, jm.DataMean.create(dim_out=3, dtype=jnp.float64),
              jnp.asarray(np.vstack([X, xn])), jnp.asarray(np.vstack([Y, yn])),
              capacity=32)
    Yp = np.zeros((32, 3))
    Yp[:16] = np.vstack([Y, yn])
    _close(multi_gp.observations_padded(mt), Yp)
    for a, b in zip(multi_gp.query(mt, _t(Xq)),
                    _jq[jmulti](mj, jnp.asarray(Xq))):
        _close(a, b)
    e = multi_gp.empty(kt, means.NullMean(dim_out=2), 2, 2, capacity=32,
                       device="cpu", dtype=torch.float64)
    assert e.dim_out == 2 and e.n == 0


def test_parallel_lf_opt_on_the_reference_perturbations():
    """ParallelLFOpt(KernelLFOpt(Rprop(20), 2 restarts)) per output, the
    port handed each output's restart perturbations as the reference draws
    them (split(key, p)[j], then its _multi_start's first key): the learned
    parameters and log-likelihoods (tests/test_models_extra.py:73-85's
    data)."""
    rng = np.random.default_rng(7)
    X = rng.uniform(size=(25, 1))
    Y = np.concatenate([np.cos(6 * X), np.sin(4 * X)], axis=1)
    kj = jk.SquaredExpARD.create(dim=1, dtype=jnp.float64)
    kt = kernels.SquaredExpARD.create(dim=1, **F64)
    mj = jax.jit(jmulti.fit, static_argnames=("capacity",))(
        kj, jm.NullMean(dim_out=2), jnp.asarray(X), jnp.asarray(Y),
        capacity=32)
    mt = multi_gp.fit(kt, means.NullMean(dim_out=2), _t(X), _t(Y),
                      capacity=32, device="cpu")
    key = jax.random.PRNGKey(0)
    R, eps = 2, 0.5
    P = kt.params_size
    perts = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(k, R + 1)[0], (R, P), dtype=jnp.float64,
        minval=-eps, maxval=eps)))(jax.random.split(key, 2)))
    mj2 = jax.jit(jmulti.ParallelLFOpt(hp_opt=JKernelLFOpt(
        JRprop(iterations=20), restarts=R)))(mj, key)
    mt2 = multi_gp.ParallelLFOpt(hp_opt=KernelLFOpt(
        Rprop(iterations=20), restarts=R))(
        mt, [torch.Generator() for _ in range(2)],
        perts=[torch.from_numpy(np.array(p)) for p in perts])
    def each(gps):
        out = [jax.tree_util.tree_map(lambda a: a[j], gps) for j in range(2)]
        return [(g.kernel.params, jgp.log_lik(g)) for g in out]

    for g, (pj, llj) in zip(mt2.gps, jax.jit(each)(mj2.gps)):
        _close(g.kernel.params, pj, rel=1e-8)
        _close(tgp.log_lik(g), llj, rel=1e-8)
    assert not torch.equal(mt2.gps[0].kernel.params,
                           mt2.gps[1].kernel.params)


def test_entry_points_default_to_the_card(monkeypatch):
    """Each family's constructors run on the card unless asked for the
    CPU, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y = np.zeros((4, 2)), np.zeros((4, 1))
    kt = kernels.Exp.create(**F64)
    for make in (lambda: iterative.fit(kt, means.NullMean(), X, Y),
                 lambda: iterative.empty(kt, means.NullMean(), 2),
                 lambda: spgp.fit(kt, means.NullMean(), X, Y, m=2),
                 lambda: spgp.empty(kt, means.NullMean(), 2),
                 lambda: sparse_gp.fit(kt, means.NullMean(), X, Y),
                 lambda: multi_gp.fit(kt, means.NullMean(), X, Y),
                 lambda: multi_gp.empty(kt, means.NullMean(), 2, 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
