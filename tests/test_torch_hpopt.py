"""The port's GP objectives and hyperparameter-learning strategies against
the JAX package's, in f64 (tests/conftest.py turns on x64), step for step.

The GP is fitted by the reference at capacity 64 and carried across with
utils/convert.py; every strategy then runs Rprop(5) on both sides and the
learned parameters and the refitted state are compared.  Random restart
perturbations are drawn by the reference and fed to the port's
deterministic ``from_inits`` / ``_multi_start(..., pert=)``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limbo_tpu.kernels as jk
import limbo_tpu.means as jm
from limbo_tpu.models import gp as jgp
from limbo_tpu.models import hp_opt as jhp
from limbo_tpu.opt.compose import ParallelRepeater as JParallelRepeater
from limbo_tpu.opt.gradient import Rprop as JRprop
from limbo_tpu_torch import kernels, means
from limbo_tpu_torch.bo import default_hp_opt
from limbo_tpu_torch.models import gp as tgp
from limbo_tpu_torch.models import hp_opt
from limbo_tpu_torch.opt import ParallelRepeater, Rprop
from limbo_tpu_torch.utils import convert

torch.set_num_threads(1)

_jfit = jax.jit(jgp.fit, static_argnames=("capacity",))
D, N0, CAP, STEPS = 3, 50, 64, 5
F64 = dict(device="cpu", dtype=torch.float64)
# f64 on both sides; the factorizations and solves sum in other orders,
# and Rprop's sign steps repeat exactly unless a gradient is ~0
TOL = dict(rtol=1e-9, atol=1e-9)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


def _flat(tree):
    return {"/".join(str(p) for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(mean="data", optimize_noise=True):
    """(reference GP, port GP) on the same seeded data: SquaredExpARD with
    the noise learned, and a DataMean or a ConstantMean."""
    rng = np.random.default_rng(5)
    X = rng.uniform(size=(N0, D))
    Y = np.sin(3.0 * X.sum(axis=1, keepdims=True)) \
        + 0.1 * rng.standard_normal((N0, 1))
    kj = jk.SquaredExpARD.create(dim=D, noise=0.05, dtype=jnp.float64,
                                 optimize_noise=optimize_noise).replace(
        log_ell=jnp.asarray([-0.7, -0.4, -0.9]))
    kt = kernels.SquaredExpARD.create(dim=D, optimize_noise=optimize_noise,
                                      **F64)
    if mean == "data":
        mj, mt = jm.DataMean.create(dtype=jnp.float64), \
            means.DataMean.create(**F64)
    else:
        mj = jm.ConstantMean.create(value=0.2, dtype=jnp.float64)
        mt = means.ConstantMean.create(value=0.0, **F64)
    gj = _jfit(kj, mj, jnp.asarray(X), jnp.asarray(Y), capacity=CAP)
    return gj, convert.to_gp(_flat(gj), kt, mt, device="cpu")


def test_objectives_and_gradients_match_reference():
    """log_lik, log_loo_cv, inv_kernel and the accessors of a fitted GP,
    then the LML and LOO objectives and their gradients in the kernel
    parameters (with a ridge), f64: 1e-9."""
    gj, gt = _pair()
    _close(tgp.log_lik(gt), jgp.log_lik(gj))
    _close(tgp.log_loo_cv(gt), jgp.log_loo_cv(gj))
    _close(tgp.inv_kernel(gt), jgp.inv_kernel(gj))
    _close(tgp.samples(gt), jgp.samples(gj))
    _close(tgp.observations(gt), jgp.observations(gj))
    _close(tgp.mean_observation(gt), jgp.mean_observation(gj))
    p = np.asarray(gj.kernel.params) + 0.1
    for jf, tf in ((jgp.log_marginal_likelihood, tgp.log_marginal_likelihood),
                   (jgp.log_loo_cv_fn, tgp.log_loo_cv_fn)):
        v, g = jax.jit(jax.value_and_grad(lambda q: jf(
            gj.kernel.with_params(q), gj.mean, gj.x, gj.y, gj.n,
            extra_jitter=1e-6)))(jnp.asarray(p))
        pt = torch.from_numpy(p).requires_grad_(True)
        vt = tf(gt.kernel.with_params(pt), gt.mean, gt.x, gt.y, gt.n,
                extra_jitter=1e-6)
        vt.backward()
        _close(vt, v)
        _close(pt.grad, g)


@pytest.mark.parametrize("name", ["KernelLFOpt", "KernelLooOpt",
                                  "KernelMeanLFOpt", "MeanLFOpt"])
def test_strategy_matches_reference(name):
    """Each strategy with Rprop(5), f64, step for step: the learned
    parameters and the refitted L and alpha within 1e-9.  KernelLFOpt runs
    with objective_jitter="auto" (an f64 ridge of ~1e-12)."""
    kw = {"objective_jitter": "auto"} if name == "KernelLFOpt" else {}
    mean = "constant" if "Mean" in name else "data"
    gj, gt = _pair(mean=mean)
    before = np.asarray(gj.kernel.params if "Kernel" in name
                        else gj.mean.params)
    sj = getattr(jhp, name)(optimizer=JRprop(iterations=STEPS), **kw)
    st = getattr(hp_opt, name)(optimizer=Rprop(iterations=STEPS), **kw)
    gj = jax.jit(lambda g: sj(g, jax.random.PRNGKey(0)))(gj)
    gt = st(gt, torch.Generator().manual_seed(0))
    _close(gt.kernel.params, gj.kernel.params)
    _close(gt.mean.params, gj.mean.params)
    _close(gt.L, gj.L)
    _close(gt.alpha, gj.alpha)
    after = gj.kernel.params if "Kernel" in name else gj.mean.params
    assert not np.allclose(np.asarray(after), before)     # it learned


def _lml_pair(gj, gt):
    """The reference's and the port's LML of the kernel parameters."""
    def fj(p):
        return jgp.log_marginal_likelihood(gj.kernel.with_params(p), gj.mean,
                                           gj.x, gj.y, gj.n)

    def ft(p):
        return tgp.log_marginal_likelihood(gt.kernel.with_params(p), gt.mean,
                                           gt.x, gt.y, gt.n)
    return fj, ft


def test_parallel_repeater_from_reference_perturbations():
    """ParallelRepeater(Rprop(5), 3 repeats) on the LML, f64: the port's
    from_inits on the reference's perturbed starts finds the same best
    point and value (1e-9)."""
    gj, gt = _pair()
    fj, ft = _lml_pair(gj, gt)
    key, eps, reps = jax.random.PRNGKey(3), 0.3, 3
    init = gj.kernel.params
    want = jax.jit(lambda k: JParallelRepeater(
        sub=JRprop(iterations=STEPS), repeats=reps, epsilon=eps)(
        fj, init, k))(key)
    pert = jax.random.uniform(jax.random.split(key, reps + 1)[0],
                              (reps, init.shape[0]), dtype=init.dtype,
                              minval=-eps, maxval=eps)
    inits = convert.to_inits(init, pert, device="cpu")
    got = ParallelRepeater(sub=Rprop(iterations=STEPS), repeats=reps,
                           epsilon=eps).from_inits(hp_opt._rowwise(ft),
                                                   inits)
    _close(got.x, want.x)
    _close(got.value, want.value)
    # BOptimizerHPOpt's default strategy
    d = default_hp_opt()
    assert isinstance(d, hp_opt.KernelLFOpt)
    assert (d.optimizer.repeats, d.optimizer.sub.iterations) == (4, 100)


def test_multi_start_from_reference_perturbations():
    """_multi_start with 3 restarts, the tiny-noise structured init and
    rank_objective, f64: the port fed the reference's perturbations picks
    the same restart and point (1e-9)."""
    gj, gt = _pair()
    fj, ft = _lml_pair(gj, gt)
    key, eps, R = jax.random.PRNGKey(4), 0.5, 3
    init = gj.kernel.params
    tiny_j = jhp._tiny_noise_init(gj, init)
    want = jax.jit(lambda k: jhp._multi_start(
        fj, init, JRprop(iterations=STEPS), k, R, eps, rank_objective=fj,
        extra_inits=tiny_j))(key)
    pert = jax.random.uniform(jax.random.split(key, R + 1)[0],
                              (R, init.shape[0]), dtype=init.dtype,
                              minval=-eps, maxval=eps)
    init_t = gt.kernel.params
    tiny_t = hp_opt._tiny_noise_init(gt, init_t)
    assert float(tiny_t[0][-1]) == math.log(0.01)
    got = hp_opt._multi_start(ft, init_t, Rprop(iterations=STEPS), None, R,
                              eps, rank_objective=ft, extra_inits=tiny_t,
                              pert=torch.from_numpy(np.array(pert)))
    _close(got.x, want.x)
    _close(got.value, want.value)
