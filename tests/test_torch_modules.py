"""The port's modules against the JAX package, on the same numpy inputs.

Deterministic code is compared in f64 (tests/conftest.py turns on x64 for
the reference) to 1e-10 unless a test says otherwise; the draws are made
with numpy or by the reference and handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limbo_tpu.acqui as jacq
import limbo_tpu.kernels as jk
import limbo_tpu.means as jm
from limbo_tpu.models import gp as jgp
from limbo_tpu.opt.compose import RandomRestarts as JRandomRestarts
from limbo_tpu.opt.gradient import Adam as JAdam
from limbo_tpu.opt.gradient import GradientAscent as JGradientAscent
from limbo_tpu.opt.gradient import Rprop as JRprop
from limbo_tpu.utils import maths as jmaths
from limbo_tpu_torch import acqui, kernels, means
from limbo_tpu_torch.models import gp as tgp
from limbo_tpu_torch.models.dispatch import add_sample_any
from limbo_tpu_torch.ops import chol
from limbo_tpu_torch.opt import Adam, GradientAscent, RandomRestarts, Rprop
from limbo_tpu_torch.utils import convert, maths

torch.set_num_threads(1)

# the reference's entry points jitted: one compile instead of one per
# primitive in eager mode, which keeps these tests inside their budget
_jfit = jax.jit(jgp.fit, static_argnames=("capacity",))
_jquery = jax.jit(jgp.query)
_jquery_cached = jax.jit(jgp.query_cached)
_jbuild = jax.jit(jgp.QueryCache.build,
                  static_argnames=("with_Linv", "qdtype", "defer_m"))
_jgrow = jax.jit(jgp.grow, static_argnums=1)

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-10, atol=1e-10)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


def test_maths_helpers():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(size=(6, 3)), rng.uniform(size=(4, 3))
    _close(maths.sq_dist(_t(a), _t(b)), jmaths.sq_dist(a, b))
    x = np.array([0.0, 0.3, 2.0])
    _close(maths.safe_sqrt(_t(x)), jmaths.safe_sqrt(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    maths.safe_sqrt(xt).sum().backward()
    _close(xt.grad, jax.grad(lambda v: jmaths.safe_sqrt(v).sum())(
        jnp.asarray(x)))                      # zero gradient at 0
    K, mask = rng.uniform(size=(5, 5)), np.array([1.0, 1, 1, 0, 0])
    _close(maths.masked_identity_gram(_t(K), _t(mask)),
           jmaths.masked_identity_gram(K, mask))
    _close(maths.flatten_params(_t(a), torch.zeros((0,)), _t(b)),
           jmaths.flatten_params(a, jnp.zeros((0,)), b))


def _kernel_pairs(rng, d=3):
    """(port kernel, reference kernel) with the same random hyperparameters."""
    A = rng.standard_normal((d, 2))
    ell = rng.uniform(-0.5, 0.5, size=d)
    pairs = [
        (kernels.Exp.create(l=0.4, noise=0.05, **F64),
         jk.Exp.create(l=0.4, noise=0.05, dtype=jnp.float64)),
        (kernels.SquaredExpARD.create(dim=d, sigma_sq=2.0, **F64)
         .replace(log_ell=_t(ell)),
         jk.SquaredExpARD.create(dim=d, sigma_sq=2.0, dtype=jnp.float64)
         .replace(log_ell=jnp.asarray(ell))),
        (kernels.SquaredExpARD.create(dim=d, rank=2, optimize_noise=True,
                                      **F64).replace(A=_t(A)),
         jk.SquaredExpARD.create(dim=d, rank=2, optimize_noise=True,
                                 dtype=jnp.float64).replace(A=jnp.asarray(A))),
        (kernels.MaternThreeHalves.create(l=0.6, sigma_sq=3.0, **F64),
         jk.MaternThreeHalves.create(l=0.6, sigma_sq=3.0, dtype=jnp.float64)),
        (kernels.MaternFiveHalves.create(l=0.6, **F64),
         jk.MaternFiveHalves.create(l=0.6, dtype=jnp.float64)),
    ]
    return pairs


@pytest.mark.parametrize("which", range(5),
                         ids=["exp", "se_ard", "se_ard_lowrank", "matern32",
                              "matern52"])
def test_kernel_matches_reference(which):
    """gram, gram_train, gram_train_masked (+ extra jitter), train_diag_add,
    the scalar form, and the params / with_params round trip."""
    rng = np.random.default_rng(1)
    kt, kj = _kernel_pairs(rng)[which]
    X1, X2 = rng.uniform(size=(9, 3)), rng.uniform(size=(6, 3))
    N, n = 12, 8
    Xp = rng.uniform(size=(N, 3))
    Xp[n:] = 0.0
    _close(kt.gram(_t(X1), _t(X2)), kj.gram(X1, X2))
    _close(kt.gram_train(_t(X1)), kj.gram_train(X1))
    _close(kt.train_diag_add(_t(X1)), kj.train_diag_add(X1))
    _close(kt(_t(X1[0]), _t(X2[1])), kj(X1[0], X2[1]))
    for extra in (None, 1e-3):
        _close(kt.gram_train_masked(_t(Xp), n, extra_jitter=extra),
               kj.gram_train_masked(jnp.asarray(Xp), jnp.asarray(n),
                                    extra_jitter=extra))
    p = rng.standard_normal(kt.params_size)
    assert kt.params_size == kj.params_size
    _close(kt.params, kj.params)
    kt2, kj2 = kt.with_params(_t(p)), kj.with_params(jnp.asarray(p))
    _close(kt2.params, p)
    _close(kt2.gram(_t(X1), _t(X2)), kj2.gram(X1, X2))
    _close(kt.params, kj.params)               # the original is unchanged


def test_means_match_reference():
    rng = np.random.default_rng(2)
    X = rng.uniform(size=(7, 2))
    Y = rng.standard_normal((10, 2))
    mask = np.array([1.0] * 6 + [0.0] * 4)
    pairs = [
        (means.NullMean(dim_out=2), jm.NullMean(dim_out=2)),
        (means.ConstantMean.create(value=1.5, dim_out=2, **F64),
         jm.ConstantMean.create(value=1.5, dim_out=2, dtype=jnp.float64)),
        (means.DataMean.create(dim_out=2, **F64),
         jm.DataMean.create(dim_out=2, dtype=jnp.float64)),
        (means.FunctionARD.create(means.DataMean.create(dim_out=2, **F64),
                                  dim_out=2, device="cpu"),
         jm.FunctionARD.create(jm.DataMean.create(dim_out=2,
                                                  dtype=jnp.float64),
                               dim_out=2)),
    ]
    for mt, mj in pairs:
        mt = means.prepare_mean(mt, _t(Y), _t(mask))
        mj = jm.prepare_mean(mj, jnp.asarray(Y), jnp.asarray(mask))
        _close(mt(_t(X)), mj(X))
        assert mt.params_size == mj.params_size
        if mt.params_size:
            p = rng.standard_normal(mt.params_size)
            _close(mt.with_params(_t(p))(_t(X)),
                   mj.with_params(jnp.asarray(p))(X))


def test_cholesky_nan_on_indefinite():
    """Indefinite input gives a non-finite factor (no raise), as the
    reference's Cholesky does; SPD input matches it."""
    A = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    assert not bool(torch.isfinite(chol.cholesky(A)).all())
    rng = np.random.default_rng(3)
    B = rng.standard_normal((6, 6))
    S = B @ B.T + 6 * np.eye(6)
    from limbo_tpu.ops.chol import cholesky as jcholesky
    _close(chol.cholesky(_t(S)), jcholesky(jnp.asarray(S)))


def _data(rng, n, d=3):
    X = rng.uniform(size=(n, d))
    Y = np.sin(3.0 * X.sum(axis=1, keepdims=True)) \
        + 0.1 * rng.standard_normal((n, 1))
    return X, Y


def _se_pair(d=3):
    return (kernels.SquaredExpARD.create(dim=d, **F64),
            jk.SquaredExpARD.create(dim=d, dtype=jnp.float64))


def test_gp_fit_query_add_sample_match_reference():
    """fit, query, add_sample (with DataMean) and grow in f64."""
    rng = np.random.default_rng(4)
    X, Y = _data(rng, 20)
    kt, kj = _se_pair()
    gt = tgp.fit(kt, means.DataMean.create(**F64), X, Y, capacity=32,
                 device="cpu")
    gj = _jfit(kj, jm.DataMean.create(dtype=jnp.float64), jnp.asarray(X),
                 jnp.asarray(Y), capacity=32)
    Xq = rng.uniform(size=(5, 3))
    for a, b in zip(tgp.query(gt, _t(Xq)), _jquery(gj, jnp.asarray(Xq))):
        _close(a, b)
    for _ in range(3):
        x, y = rng.uniform(size=3), rng.standard_normal(1)
        gt = add_sample_any(gt, _t(x), _t(y))
        gj = jax.jit(jgp.add_sample)(gj, jnp.asarray(x), jnp.asarray(y))
    assert gt.n == int(gj.n) == 23
    _close(gt.L, gj.L)
    _close(gt.alpha, gj.alpha)
    gt, gj = tgp.grow(gt, 64), _jgrow(gj, 64)
    for a, b in zip(tgp.query(gt, _t(Xq)), _jquery(gj, jnp.asarray(Xq))):
        _close(a, b)


def _bumps(Xj_or_t):
    """A smooth multi-modal test objective, written for both frameworks."""
    mod = jnp if isinstance(Xj_or_t, jax.Array) else torch
    return (-mod.sum((Xj_or_t - 0.3) ** 2, -1)
            + 0.3 * mod.sin(7.0 * mod.sum(Xj_or_t, -1)))


def test_rprop_matches_reference():
    """Rprop from the same 6 starts (bounded and not), f64: the port's
    batched ascent against the reference's vmap."""
    rng = np.random.default_rng(5)
    starts = rng.uniform(size=(6, 3))
    for bounded in (True, False):
        jres = jax.vmap(lambda x0: JRprop(iterations=15)(
            _bumps, x0, None, bounded))(jnp.asarray(starts))
        tres = Rprop(iterations=15)(_bumps, _t(starts), None, bounded)
        _close(tres.x, jres.x)
        _close(tres.value, jres.value)
    # resumable: 10 + 5 steps equal 15
    r1, st = Rprop(iterations=10).run(_bumps, _t(starts), None, True)
    r2, _ = Rprop(iterations=10).run(_bumps, None, None, True, state=st,
                                     iterations=5)
    r3 = Rprop(iterations=15)(_bumps, _t(starts), None, True)
    _close(r2.x, r3.x.numpy())
    # eps_stop freezes a start once its step's gradient norm is small
    jres = jax.vmap(lambda x0: JRprop(iterations=15, eps_stop=0.5)(
        _bumps, x0, None, True))(jnp.asarray(starts))
    tres = Rprop(iterations=15, eps_stop=0.5)(_bumps, _t(starts), None, True)
    _close(tres.x, jres.x)


@pytest.mark.parametrize("which", ["adam", "ga", "momentum", "nesterov"])
def test_adam_and_gradient_ascent_match_reference(which):
    rng = np.random.default_rng(9)
    starts = rng.uniform(size=(5, 3))
    pt, pj = {
        "adam": (Adam(iterations=12, alpha=0.05),
                 JAdam(iterations=12, alpha=0.05)),
        "ga": (GradientAscent(iterations=12, alpha=0.05),
               JGradientAscent(iterations=12, alpha=0.05)),
        "momentum": (GradientAscent(iterations=12, alpha=0.05, gamma=0.5),
                     JGradientAscent(iterations=12, alpha=0.05, gamma=0.5)),
        "nesterov": (GradientAscent(iterations=12, alpha=0.05, gamma=0.5,
                                    nesterov=True),
                     JGradientAscent(iterations=12, alpha=0.05, gamma=0.5,
                                     nesterov=True)),
    }[which]
    jres = jax.vmap(lambda x0: pj(_bumps, x0, None, True))(
        jnp.asarray(starts))
    tres = pt(_bumps, _t(starts), None, True)
    _close(tres.x, jres.x)
    _close(tres.value, jres.value)
    one = pt(_bumps, _t(starts[0]), None, True)      # a (d,) start
    _close(one.x, jres.x[0])


def test_rprop_sanitizes_nan():
    """A start whose objective is NaN loses instead of poisoning the
    batch (the reference's _sanitize, per restart)."""
    def f(X):
        return torch.where(X[:, 0] > 0.9, torch.nan, -X.sum(dim=1))

    starts = torch.tensor([[0.95, 0.5], [0.5, 0.5]], dtype=torch.float64)
    res = Rprop(iterations=5)(f, starts, None, True)
    assert bool(torch.isfinite(res.value[1]))
    assert bool(torch.isfinite(res.x).all())


def test_random_restarts_from_reference_sweep():
    """RandomRestarts seeded from the reference's own sweep draw: the same
    best point and value (f64)."""
    key = jax.random.PRNGKey(3)
    d = 3
    opt_j = JRandomRestarts(sub=JRprop(iterations=8), repeats=6,
                            sweep_samples=40)
    init = jnp.full((d,), 0.5)
    jres = opt_j(_bumps, init, key, True)
    sweep = jax.random.uniform(jax.random.split(key, 3)[2], (40, d),
                               dtype=init.dtype)
    opt_t = RandomRestarts(sub=Rprop(iterations=8), repeats=6,
                           sweep_samples=40)
    tres = opt_t.from_sweep(_bumps, _t(init), _t(sweep), True)
    _close(tres.x, jres.x)
    _close(tres.value, jres.value)
    # __call__ draws its own sweep from the generator
    gen = torch.Generator().manual_seed(0)
    res = opt_t(_bumps, _t(init), gen, True)
    assert res.x.shape == (d,) and bool(torch.isfinite(res.value))


@pytest.mark.parametrize("which", ["ucb", "gp_ucb", "ei", "ucb_mean_agg",
                                   "ei_distance"])
def test_acquisitions_match_reference(which):
    """Acquisition values on a (q, d) batch against the reference's vmapped
    per-point form, f64, two-output GP for the aggregators."""
    rng = np.random.default_rng(6)
    X = rng.uniform(size=(15, 3))
    Y = np.concatenate([np.sin(3.0 * X.sum(1, keepdims=True)),
                        np.cos(2.0 * X[:, :1])], axis=1)
    kt, kj = _se_pair()
    gt = tgp.fit(kt, means.DataMean.create(dim_out=2, **F64), X, Y,
                 device="cpu")
    gj = _jfit(kj, jm.DataMean.create(dim_out=2, dtype=jnp.float64),
                 jnp.asarray(X), jnp.asarray(Y))
    Xq = rng.uniform(size=(4, 3))
    pt, pj = {
        "ucb": (lambda g, Z: acqui.UCB(alpha=0.5)(g, Z),
                lambda g, x: jacq.UCB(alpha=0.5)(g, x)),
        "gp_ucb": (lambda g, Z: acqui.GP_UCB()(g, Z, iteration=5),
                   lambda g, x: jacq.GP_UCB()(g, x, iteration=5)),
        "ei": (lambda g, Z: acqui.EI(jitter=0.01)(g, Z),
               lambda g, x: jacq.EI(jitter=0.01)(g, x)),
        "ucb_mean_agg": (
            lambda g, Z: acqui.UCB()(g, Z, aggregator=acqui.MeanAggregator),
            lambda g, x: jacq.UCB()(g, x, aggregator=jacq.MeanAggregator)),
        "ei_distance": (
            lambda g, Z: acqui.EI()(g, Z, aggregator=acqui.DistanceToTarget(
                [0.2, 0.1])),
            lambda g, x: jacq.EI()(g, x, aggregator=jacq.DistanceToTarget(
                jnp.asarray([0.2, 0.1])))),
    }[which]
    want = jax.vmap(lambda x: pj(gj, x))(jnp.asarray(Xq))
    # 1e-8: the two libraries' erfc differ in the last digits
    _close(pt(gt, _t(Xq)), want, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("mode", [False, "linv"])
def test_add_sample_cached_modes_match_reference(mode):
    """The solve and "linv" cached appends (no deferral), f64: GP, K^{-1},
    Linv and the f64 mirror after three appends."""
    rng = np.random.default_rng(8)
    X, Y = _data(rng, 30)
    kt, kj = _se_pair()
    gt = tgp.fit(kt, means.DataMean.create(**F64), X, Y, capacity=64,
                 device="cpu")
    gj = _jfit(kj, jm.DataMean.create(dtype=jnp.float64), jnp.asarray(X),
                 jnp.asarray(Y), capacity=64)
    ct = tgp.QueryCache.build(gt, with_Linv=True, qdtype=torch.float64)
    cj = _jbuild(gj, with_Linv=True, qdtype=jnp.float64)
    for _ in range(3):
        x, y = rng.uniform(size=3), rng.standard_normal(1)
        gt, ct = tgp.add_sample_cached(gt, ct, _t(x), _t(y),
                                       fast_update=mode)
        gj, cj = jax.jit(jgp.add_sample_cached, static_argnums=4)(
            gj, cj, jnp.asarray(x), jnp.asarray(y), mode)
    for a, b in ((gt.L, gj.L), (gt.alpha, gj.alpha), (ct.Kinv, cj.Kinv),
                 (ct.Linv, cj.Linv), (ct.Kinv_q, cj.Kinv_q)):
        _close(a, b, rtol=0, atol=1e-9 * float(np.abs(np.asarray(b)).max()))


def test_convert_carries_gp_and_cache():
    """A JAX GP and deferred bf16-mirror cache, flattened by pytree path,
    become the port's GP and cache: the same posterior, and the same state
    after one deferred append on both sides (f32)."""
    rng = np.random.default_rng(7)
    X, Y = _data(rng, 40)
    kj = jk.SquaredExpARD.create(dim=3, dtype=jnp.float32).replace(
        log_ell=jnp.asarray([-0.2, 0.1, 0.3], jnp.float32))
    gj = _jfit(kj, jm.DataMean.create(dtype=jnp.float32),
                 jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
                 capacity=64)
    cj = _jbuild(gj, with_Linv=True, qdtype=jnp.bfloat16,
                              defer_m=4)

    def flat(tree):
        return {"/".join(str(p) for p in path): np.asarray(leaf) for path,
                leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    gt = convert.to_gp(flat(gj), kernels.SquaredExpARD.create(dim=3,
                                                              device="cpu"),
                       means.DataMean.create(device="cpu"), device="cpu")
    ct = convert.to_cache(flat(cj), device="cpu")
    assert gt.n == 40 and ct.base_n == 40 and isinstance(gt.n, int)
    assert ct.Kinv_q.dtype == torch.bfloat16
    _close(ct.Kinv_q.float(), np.asarray(cj.Kinv_q, np.float32), rtol=0,
           atol=0)
    _close(gt.kernel.log_ell, kj.log_ell, rtol=0, atol=0)
    Xq = rng.uniform(size=(5, 3)).astype(np.float32)
    for a, b in zip(tgp.query_cached(gt, ct, _t(Xq)),
                    _jquery_cached(gj, cj, jnp.asarray(Xq))):
        _close(a, b, rtol=1e-5, atol=1e-5)
    x, y = rng.uniform(size=3).astype(np.float32), np.array([0.3], np.float32)
    gt, ct = tgp.add_sample_cached(gt, ct, _t(x), _t(y),
                                   fast_update="deferred")
    gj, cj = jax.jit(jgp.add_sample_cached, static_argnums=4)(
        gj, cj, jnp.asarray(x), jnp.asarray(y), "deferred")
    # f32 solves in two libraries: |err| <= 1e-4 max|ref| per buffer
    for a, b in ((gt.L, gj.L), (gt.alpha, gj.alpha), (ct.Linv, cj.Linv),
                 (ct.P, cj.P), (ct.ay, cj.ay), (ct.u_ones, cj.u_ones)):
        _close(a, b, rtol=0, atol=1e-4 * float(np.abs(np.asarray(b)).max()))
