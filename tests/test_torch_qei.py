"""Batch BO against the JAX package's: q-EI's joint posterior (one GP and a
MultiGP), QEI on the same base normals, propose_batch on the reference's
draws, and BOptimizer.optimize_batch against tests/test_qei.py's own
assertions.

Inputs are made from a seed with NumPy, in f64 on the CPU (tests/conftest.py
enables x64 for the reference).  Tolerances: the joint posterior and QEI to
1e-12 relative to their scale (the two libraries sum in other orders), the
proposed batch to 1e-8 (Rprop's sign steps amplify the last bits only where
a gradient component is near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limbo_tpu.acqui.qei as jqei
import limbo_tpu.kernels as jk
import limbo_tpu.means as jm
from limbo_tpu.models import gp as jgp
from limbo_tpu.models import multi_gp as jmulti
from limbo_tpu_torch import kernels, means
from limbo_tpu_torch.acqui import EI, FirstElem
from limbo_tpu_torch.acqui import qei
from limbo_tpu_torch.models import gp as tgp
from limbo_tpu_torch.models import multi_gp

torch.set_num_threads(1)

_jjp = jax.jit(jqei.joint_posterior)
_jjpm = jax.jit(jqei.joint_posterior_multi)
_jqei = jax.jit(lambda gp, X, base: jqei.QEI()(gp, X, base))

F64 = dict(device="cpu", dtype=torch.float64)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(got, want, rel=1e-12):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _gps(rng, n=12, d=1):
    """tests/test_qei.py's GP (Exp l = 0.2, NullMean, sin(6x), capacity 16)
    in both packages."""
    X = rng.uniform(size=(n, d))
    Y = np.sin(6 * X.sum(1, keepdims=True))
    j = jax.jit(jgp.fit, static_argnames="capacity")(
        jk.Exp.create(l=0.2, dtype=jnp.float64), jm.NullMean(),
        jnp.asarray(X), jnp.asarray(Y), capacity=16)
    t = tgp.fit(kernels.Exp.create(l=0.2, **F64), means.NullMean(), _t(X),
                _t(Y), capacity=16, **F64)
    return j, t


def test_joint_posterior_and_qei_equal_reference():
    """joint_posterior on (q, d) and on a (B, q, d) batch, the MultiGP's
    joint_posterior_multi with a DataMean, and QEI on the same base
    normals, against the reference."""
    rng = np.random.default_rng(0)
    jg, tg = _gps(rng, d=2)
    Xb = rng.uniform(size=(3, 4, 2))
    mu, cov = qei.joint_posterior(tg, _t(Xb))
    for b in range(3):
        jmu, jcov = _jjp(jg, jnp.asarray(Xb[b]))
        _close(mu[b], jmu)
        _close(cov[b], jcov)
    mu1, cov1 = qei.joint_posterior(tg, _t(Xb[1]))
    _close(mu1, mu[1])
    _close(cov1, cov[1])
    base = rng.normal(size=(64, 4))
    got = qei.QEI()(tg, _t(Xb), _t(base))
    for b in range(3):
        _close(got[b], _jqei(jg, jnp.asarray(Xb[b]), jnp.asarray(base)))

    X = rng.uniform(size=(10, 2))
    Y = np.stack([np.sin(3 * X.sum(1)), np.cos(3 * X[:, 0])], axis=1)
    jm_ = jax.jit(jmulti.fit, static_argnames="capacity")(
        jk.MaternFiveHalves.create(dtype=jnp.float64),
                     jm.DataMean.create(dim_out=2, dtype=jnp.float64),
                     jnp.asarray(X), jnp.asarray(Y), capacity=16)
    tm = multi_gp.fit(kernels.MaternFiveHalves.create(**F64),
                      means.DataMean.create(dim_out=2, **F64), _t(X), _t(Y),
                      capacity=16, **F64)
    mus, covs = qei.joint_posterior_multi(tm, _t(Xb))
    for b in range(3):
        jmu, jcov = _jjpm(jm_, jnp.asarray(Xb[b]))
        _close(mus[b], jmu)
        _close(covs[b], jcov)


def test_propose_batch_equals_reference_on_its_draws():
    """propose_batch(q = 3, 6 restarts, Rprop(15)) given the reference's
    base normals and starts (its key's draws) proposes its batch."""
    rng = np.random.default_rng(1)
    jg, tg = _gps(rng)
    key = jax.random.PRNGKey(2)
    Xj, vj = jax.jit(lambda gp, k: jqei.propose_batch(
        gp, 3, k, restarts=6, steps=15))(jg, key)
    k_base, k_init, _ = jax.random.split(key, 3)
    base = jax.random.normal(k_base, (128, 3), dtype=jnp.float64)
    inits = jax.random.uniform(k_init, (6, 3), dtype=jnp.float64)
    Xt, vt = qei.propose_batch_from(tg, 3, _t(base), _t(inits), steps=15)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-8)


def test_qei_properties_as_the_reference_tests():
    """tests/test_qei.py's assertions on the port: the joint posterior's
    diagonal is the query's, PSD; q = 1 is EI; a diverse pair beats either
    point; propose_batch gives a (3, 1) batch in the box, qEI >= 0."""
    rng = np.random.default_rng(42)
    _, gp = _gps(rng)
    Xb = _t(rng.uniform(size=(4, 1)))
    mu_j, cov = qei.joint_posterior(gp, Xb)
    mu_q, var_q = tgp.query(gp, Xb)
    np.testing.assert_allclose(mu_j.numpy(), mu_q[:, 0].numpy(), atol=1e-10)
    np.testing.assert_allclose(torch.diagonal(cov).numpy(), var_q.numpy(),
                               atol=2e-6)
    assert np.linalg.eigvalsh(cov.numpy()).min() > -1e-9
    g = torch.Generator().manual_seed(0)
    x = _t([[0.47]])
    got = float(qei.QEI()(gp, x, torch.randn((200_000, 1), generator=g,
                                             dtype=torch.float64)))
    want = float(EI()(gp, x, FirstElem, 0)[0])
    np.testing.assert_allclose(got, want, rtol=0.03, atol=1e-4)
    base2 = torch.randn((50_000, 2), generator=g, dtype=torch.float64)
    xa, xb = _t([[0.3]]), _t([[0.8]])
    q = qei.QEI()
    v_pair = float(q(gp, torch.cat([xa, xb]), base2))
    assert v_pair >= max(float(q(gp, xa, base2[:, :1])),
                         float(q(gp, xb, base2[:, :1]))) - 1e-4
    Xp, val = qei.propose_batch(gp, 3, g, restarts=6, steps=15)
    assert Xp.shape == (3, 1)
    assert bool(((Xp >= 0) & (Xp <= 1)).all()) and float(val) >= 0


@pytest.mark.parametrize("dtype,kw", [
    (torch.float64, {}), (torch.float32, {}),
    (torch.float64, dict(use_query_cache=True,
                         cache_fast_update="deferred"))])
def test_optimize_batch_loop(dtype, kw):
    """tests/test_qei.py's batch loop: 5 init points, 4 rounds of q = 3,
    n == 17, best > -0.05; best_value is the best observation and the
    GP's factor is current after the appends, with the query cache on as
    well (the batch loop appends to the GP, as the reference's does)."""
    from limbo_tpu_torch.bo import BOptimizer, MaxIterations, RandomSampling

    def f(x):
        return np.array([-np.sum((np.atleast_1d(x) - 0.4) ** 2)])

    bo = BOptimizer(init=RandomSampling(5), stop=(MaxIterations(4),),
                    stats_enabled=False, dtype=dtype, device="cpu", **kw)
    state = bo.optimize_batch(f, dim_in=1, q=3, restarts=8, steps=15,
                              generator=torch.Generator().manual_seed(0))
    n = state.gp.n
    assert n == 5 + 4 * 3 and state.iteration == 4
    assert state.best_value > -0.05
    obs = torch.tensor([f(x)[0] for x in state.gp.x[:n].numpy()],
                       dtype=dtype)
    assert state.best_value == float(obs.max())
    assert state.last_sample.shape == (3, 1)
    K = state.gp.kernel.gram_train_masked(state.gp.x, n)
    L = state.gp.L
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose((L @ L.T).numpy(), K.numpy(), atol=tol)
