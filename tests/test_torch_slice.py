"""The port's cached BO iteration against the JAX package's, step by step
(slice 1), and hyperparameter learning followed by cached iterations
(slice 2, the last test).

The bench.py iteration at a CPU size: SquaredExpARD + DataMean fit at
capacity 256 (d = 3), QueryCache.build(with_Linv, bf16 mirror, defer_m=4),
then defer_m + 2 iterations of RandomRestarts(Rprop(5), 8 restarts,
64-point sweep) maximizing UCB over a CachedGPView and a deferred append,
so one flush happens.  f64 (tests/conftest.py enables x64 for the
reference); the port is fed the reference's own sweep draws, and the next
point and the whole GP / cache state are compared after every append.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import limbo_tpu.acqui as jacq
import limbo_tpu.kernels as jk
import limbo_tpu.means as jm
from limbo_tpu.models import gp as jgp
from limbo_tpu.models import hp_opt as jhp
from limbo_tpu.opt.compose import RandomRestarts as JRandomRestarts
from limbo_tpu.opt.gradient import Rprop as JRprop
from limbo_tpu_torch import acqui, kernels, means
from limbo_tpu_torch.models import gp as tgp
from limbo_tpu_torch.models import hp_opt
from limbo_tpu_torch.opt import RandomRestarts, Rprop

torch.set_num_threads(1)

# the reference's entry points jitted: one compile instead of one per
# primitive in eager mode, which keeps these tests inside their budget
_jfit = jax.jit(jgp.fit, static_argnames=("capacity",))
_jquery_cached = jax.jit(jgp.query_cached)
_jbuild = jax.jit(jgp.QueryCache.build,
                  static_argnames=("with_Linv", "qdtype", "defer_m"))

D, N0, CAP, DEFER_M = 3, 200, 256, 4
RESTARTS, STEPS, SWEEP = 8, 5, 64


def _close(got, want, rel=1e-9):
    """|err| <= rel * max|ref| (f64: summation order differs between the
    two libraries' products and solves)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def test_cached_bo_iterations_match_reference():
    rng = np.random.default_rng(11)
    X = rng.uniform(size=(N0, D))
    Y = np.sin(3.0 * X.sum(axis=1, keepdims=True)) \
        + 0.1 * rng.standard_normal((N0, 1))
    ell = np.array([-0.7, -0.4, -0.9])          # length scales 0.4 to 0.7

    kj = jk.SquaredExpARD.create(dim=D, dtype=jnp.float64).replace(
        log_ell=jnp.asarray(ell))
    gj = _jfit(kj, jm.DataMean.create(dtype=jnp.float64), jnp.asarray(X),
                 jnp.asarray(Y), capacity=CAP)
    cj = _jbuild(gj, with_Linv=True, qdtype=jnp.bfloat16,
                              defer_m=DEFER_M)
    kt = kernels.SquaredExpARD.create(dim=D, device="cpu",
                                      dtype=torch.float64).replace(
        log_ell=torch.from_numpy(ell))
    gt = tgp.fit(kt, means.DataMean.create(device="cpu", dtype=torch.float64),
                 X, Y, capacity=CAP, device="cpu")
    ct = tgp.QueryCache.build(gt, with_Linv=True, qdtype=torch.bfloat16,
                              defer_m=DEFER_M)
    _close(gt.L, gj.L)
    _close(ct.Kinv, cj.Kinv)

    opt_j = JRandomRestarts(sub=JRprop(iterations=STEPS), repeats=RESTARTS,
                            sweep_samples=SWEEP)
    opt_t = RandomRestarts(sub=Rprop(iterations=STEPS), repeats=RESTARTS,
                           sweep_samples=SWEEP)

    @jax.jit
    def jax_iter(gp, cache, key):
        view = jgp.CachedGPView(gp, cache)
        res = opt_j(lambda x: jacq.UCB(alpha=0.5)(view, x),
                    jnp.full((D,), 0.5), key, True)
        y = jnp.sin(3.0 * jnp.sum(res.x))[None]
        return (res.x,) + jgp.add_sample_cached(gp, cache, res.x, y,
                                                fast_update="deferred")

    start = torch.full((D,), 0.5, dtype=torch.float64)
    for it in range(DEFER_M + 2):
        key = jax.random.PRNGKey(it)
        x_j, gj, cj = jax_iter(gj, cj, key)
        sweep = jax.random.uniform(jax.random.split(key, 3)[2], (SWEEP, D),
                                   dtype=jnp.float64)
        view = tgp.CachedGPView(gt, ct)
        res = opt_t.from_sweep(lambda Z: acqui.UCB(alpha=0.5)(view, Z),
                               start, torch.from_numpy(np.array(sweep)),
                               True)
        _close(res.x, x_j)
        y = torch.sin(3.0 * torch.sum(res.x))[None]
        gt, ct = tgp.add_sample_cached(gt, ct, res.x, y,
                                       fast_update="deferred")
        assert gt.n == int(gj.n) == N0 + it + 1
        assert ct.base_n == int(cj.base_n)
        for a, b in ((gt.x, gj.x), (gt.y, gj.y), (gt.L, gj.L),
                     (gt.alpha, gj.alpha), (gt.mean.value, gj.mean.value),
                     (ct.Kinv, cj.Kinv), (ct.Linv, cj.Linv), (ct.P, cj.P),
                     (ct.ay, cj.ay), (ct.u_ones, cj.u_ones)):
            _close(a, b)
        # the bf16 mirror: the same rounding of the same f64 inverse
        _close(ct.Kinv_q.double(), np.asarray(cj.Kinv_q, np.float64),
               rel=2.0 ** -8)
    assert ct.base_n == N0 + DEFER_M           # the flush happened

    Xq = torch.rand((16, D), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    for a, b in zip(tgp.query_cached(gt, ct, Xq),
                    _jquery_cached(gj, cj, jnp.asarray(Xq.numpy()))):
        _close(a, b)


def test_hp_learning_then_cached_iterations_match_reference():
    """Slice 2 at a CPU size, f64: fit at capacity 256, KernelLFOpt with
    Rprop(5) (its refit is the recompute), QueryCache.build(with_Linv, bf16
    mirror, defer_m=2), then 3 cached BO iterations with deferred appends
    (one flush).  The learned parameters, the refitted factor and every
    iteration's point and state match the reference (1e-9 of max|ref|)."""
    rng = np.random.default_rng(12)
    X = rng.uniform(size=(N0, D))
    Y = np.sin(3.0 * X.sum(axis=1, keepdims=True)) \
        + 0.3 * rng.standard_normal((N0, 1))
    kj = jk.SquaredExpARD.create(dim=D, noise=0.09, dtype=jnp.float64)
    kt = kernels.SquaredExpARD.create(dim=D, noise=0.09, device="cpu",
                                      dtype=torch.float64)
    gj = _jfit(kj, jm.DataMean.create(dtype=jnp.float64), jnp.asarray(X),
               jnp.asarray(Y), capacity=CAP)
    gt = tgp.fit(kt, means.DataMean.create(device="cpu", dtype=torch.float64),
                 X, Y, capacity=CAP, device="cpu")
    sj = jhp.KernelLFOpt(optimizer=JRprop(iterations=STEPS))
    gj = jax.jit(lambda g: sj(g, jax.random.PRNGKey(0)))(gj)
    gt = hp_opt.KernelLFOpt(optimizer=Rprop(iterations=STEPS))(
        gt, torch.Generator().manual_seed(0))
    _close(gt.kernel.params, gj.kernel.params)
    _close(gt.L, gj.L)
    _close(gt.alpha, gj.alpha)

    cj = _jbuild(gj, with_Linv=True, qdtype=jnp.bfloat16, defer_m=2)
    ct = tgp.QueryCache.build(gt, with_Linv=True, qdtype=torch.bfloat16,
                              defer_m=2)
    opt_j = JRandomRestarts(sub=JRprop(iterations=STEPS), repeats=RESTARTS,
                            sweep_samples=SWEEP)
    opt_t = RandomRestarts(sub=Rprop(iterations=STEPS), repeats=RESTARTS,
                           sweep_samples=SWEEP)

    @jax.jit
    def jax_iter(gp, cache, key):
        view = jgp.CachedGPView(gp, cache)
        res = opt_j(lambda x: jacq.UCB(alpha=0.5)(view, x),
                    jnp.full((D,), 0.5), key, True)
        y = jnp.sin(3.0 * jnp.sum(res.x))[None]
        return (res.x,) + jgp.add_sample_cached(gp, cache, res.x, y,
                                                fast_update="deferred")

    start = torch.full((D,), 0.5, dtype=torch.float64)
    for it in range(3):
        key = jax.random.PRNGKey(10 + it)
        x_j, gj, cj = jax_iter(gj, cj, key)
        sweep = jax.random.uniform(jax.random.split(key, 3)[2], (SWEEP, D),
                                   dtype=jnp.float64)
        view = tgp.CachedGPView(gt, ct)
        res = opt_t.from_sweep(lambda Z: acqui.UCB(alpha=0.5)(view, Z),
                               start, torch.from_numpy(np.array(sweep)),
                               True)
        _close(res.x, x_j)
        y = torch.sin(3.0 * torch.sum(res.x))[None]
        gt, ct = tgp.add_sample_cached(gt, ct, res.x, y,
                                       fast_update="deferred")
        for a, b in ((gt.L, gj.L), (gt.alpha, gj.alpha), (ct.Kinv, cj.Kinv),
                     (ct.Linv, cj.Linv), (ct.P, cj.P)):
            _close(a, b)
    assert ct.base_n == int(cj.base_n) == N0 + 2      # the flush happened
