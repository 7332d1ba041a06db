"""Constrained BO against the JAX package's: the augmented-Lagrangian
wrapper (opt/constrained.py), ECI and one CBOptimizer step (bo/cbo.py),
and the reference tests' own assertions on the port's loop.

Inputs are made from a seed with NumPy, in f64 on the CPU (tests/conftest.py
enables x64 for the reference).  Tolerances: the CBO step's proposal to
1e-9 (20 Rprop steps from the reference's starts); the augmented
Lagrangian's iterates, after 12 x 150 Rprop steps that end at the optimum,
where a gradient component sits at zero and its sign follows the last bit,
to 1e-5, ten of Rprop's smallest steps (dmin = 1e-6), and on most starts
exactly; ECI to 1e-12 relative to its scale (the libraries sum in other
orders).  The CMA-ES problem draws from torch's generator, which cannot
repeat the reference's key, so it is held to the reference test's
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limbo_tpu.kernels as jk
import limbo_tpu.means as jm
from limbo_tpu.bo import MaxIterations as JMaxIterations
from limbo_tpu.bo import RandomSampling as JRandomSampling
from limbo_tpu.bo.cbo import ECI as JECI
from limbo_tpu.bo.cbo import CBOptimizer as JCBOptimizer
from limbo_tpu.models import gp as jgp
from limbo_tpu.opt.compose import RandomRestarts as JRandomRestarts
from limbo_tpu.opt.constrained import AugmentedLagrangian as JAugLag
from limbo_tpu.opt.gradient import Rprop as JRprop
from limbo_tpu_torch import kernels, means
from limbo_tpu_torch.bo import MaxIterations
from limbo_tpu_torch.bo.cbo import ECI, CBOptimizer
from limbo_tpu_torch.models import gp as tgp
from limbo_tpu_torch.opt import AugmentedLagrangian, Cmaes, RandomRestarts, Rprop
from limbo_tpu_torch.utils import convert

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
_jfit = jax.jit(jgp.fit, static_argnames=("capacity",))


def _flat(tree):
    return {"/".join(str(p) for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# AugmentedLagrangian (tests/test_optimizers.py:183-277, test_nlopt.cpp)
# ---------------------------------------------------------------------------

def _sq(x):
    return -x[0] ** 2 - x[1] ** 2


# name -> (outer iterations, kind, constraint on one point (reference),
#          constraint on a batch (port), objective (reference), objective
#          (port), the starts, the solution, the reference test's atol)
_PROBLEMS = {
    "equality": (12, "eq", lambda x: x[0] + 3.0 * x[1] - 10.0,
                 lambda X: X[:, 0] + 3.0 * X[:, 1] - 10.0, _sq,
                 lambda X: -X[:, 0] ** 2 - X[:, 1] ** 2, None, [1.0, 3.0],
                 1e-4),
    "inequality": (12, "in", lambda x: -x[0] - 3.0 * x[1] + 10.0,
                   lambda X: -X[:, 0] - 3.0 * X[:, 1] + 10.0, _sq,
                   lambda X: -X[:, 0] ** 2 - X[:, 1] ** 2, None, [1.0, 3.0],
                   1e-3),
    "inactive": (8, "in", lambda x: x[0] + x[1] - 100.0,
                 lambda X: X[:, 0] + X[:, 1] - 100.0,
                 lambda x: -jnp.sum((x - 0.5) ** 2),
                 lambda X: -torch.sum((X - 0.5) ** 2, dim=1),
                 [[3.0, -2.0]], [0.5, 0.5], 1e-5),
}


@pytest.mark.parametrize("name", list(_PROBLEMS))
def test_auglag_equals_reference(name):
    """The reference tests' three Rprop(150) problems from the same starts:
    the port's (R, d) batch of starts, each with its own multipliers, gives
    the reference's iterate for each start (its vmap) to 1e-5 (ten dmin
    steps), and the solution to the reference test's tolerance."""
    outer, kind, cj, ct, fj, ft, starts, sol, atol = _PROBLEMS[name]
    X0 = (np.asarray(starts) if starts is not None
          else np.random.default_rng(3).uniform(size=(2, 2)))
    j = JAugLag(sub=JRprop(iterations=150), outer_iterations=outer)
    t = AugmentedLagrangian(sub=Rprop(iterations=150), outer_iterations=outer)
    if kind == "eq":
        j, t = j.add_equality_constraint(cj), t.add_equality_constraint(ct)
    else:
        j, t = j.add_inequality_constraint(cj), t.add_inequality_constraint(ct)
    run = jax.jit(lambda x0: j(fj, x0, jax.random.PRNGKey(0), False))
    res = t(ft, torch.from_numpy(X0), torch.Generator().manual_seed(0), False)
    assert res.x.shape == X0.shape and res.value.shape == (len(X0),)
    for i, x0 in enumerate(X0):
        ref = run(jnp.asarray(x0))
        np.testing.assert_allclose(res.x[i].numpy(), np.asarray(ref.x),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(res.value[i]), float(ref.value),
                                   rtol=1e-5)
    # a (d,) start gives the batch's row
    one = t(ft, torch.from_numpy(X0[0]), torch.Generator().manual_seed(0),
            False)
    np.testing.assert_array_equal(one.x.numpy(), res.x[0].numpy())
    best = min(res.x.numpy(), key=lambda x: np.linalg.norm(x - sol))
    np.testing.assert_allclose(best, sol, atol=atol)


def test_auglag_with_cmaes_sub():
    """The wrapper composes with the gradient-free CMA-ES
    (tests/test_optimizers.py:263-277); its draws are torch's, so it is
    held to the reference test's tolerance."""
    opt = AugmentedLagrangian(sub=Cmaes(iterations=60, pop_size=16),
                              outer_iterations=6)
    opt = opt.add_equality_constraint(lambda X: X[:, 0] + X[:, 1] - 1.0)

    res = opt(lambda X: -torch.sum(X ** 2, dim=1),
              torch.tensor([0.9, 0.9], dtype=torch.float64),
              torch.Generator().manual_seed(0), True)
    np.testing.assert_allclose(res.x.numpy(), [0.5, 0.5], atol=5e-2)


def test_auglag_composition_and_generator_split():
    """add_*_constraint returns a new object and leaves the old one; each
    outer round draws its sub-generator's seed from the caller's
    generator, one draw a round."""
    base = AugmentedLagrangian(sub=Rprop(iterations=5), outer_iterations=3)
    one = base.add_inequality_constraint(lambda X: X[:, 0])
    two = one.add_equality_constraint(lambda X: X[:, 1])
    assert base.inequality == () and base.equality == ()
    assert len(one.inequality) == 1 and one.equality == ()
    assert len(two.inequality) == 1 and len(two.equality) == 1
    seen = []

    class Sub:
        def __call__(self, fun, init, generator, bounded):
            seen.append(generator.initial_seed())
            return Rprop(iterations=2)(fun, init, generator, bounded)

    gen = torch.Generator().manual_seed(11)
    AugmentedLagrangian(sub=Sub(), outer_iterations=3)(
        lambda X: -torch.sum(X ** 2, dim=1), torch.zeros(2,
                                                         dtype=torch.float64),
        gen, False)
    ref = torch.Generator().manual_seed(11)
    want = [int(torch.randint(0, 2 ** 62, (1,), generator=ref))
            for _ in range(3)]
    assert seen == want
    assert torch.equal(gen.get_state(), ref.get_state())


# ---------------------------------------------------------------------------
# ECI and CBOptimizer
# ---------------------------------------------------------------------------

def constrained_f(x):
    """Maximize -(x-0.75)^2; feasible iff x <= 0.5 (constraint obs 1/0)
    (tests/test_mo_bo.py:77-82)."""
    v = float(np.atleast_1d(x)[0])
    obj = -(v - 0.75) ** 2
    feas = 1.0 if v <= 0.5 else 0.0
    return np.array([obj, feas])


def constrained_2d(x):
    x = np.asarray(x, dtype=np.float64)
    return np.array([-np.sum((x - 0.75) ** 2),
                     1.0 if x.sum() <= 0.9 else 0.0])


def _gp_pairs(rng, n=10, d=2, capacity=64):
    """The CBO's two default models on seeded data, fitted by the reference
    and carried across with utils/convert.py."""
    X = rng.uniform(size=(n, d))
    Y = np.stack([constrained_2d(x) for x in X])
    jo = _jfit(jk.MaternFiveHalves.create(dtype=jnp.float64),
               jm.DataMean.create(dtype=jnp.float64), jnp.asarray(X),
               jnp.asarray(Y[:, :1]), capacity=capacity)
    jc = _jfit(jk.Exp.create(dtype=jnp.float64),
               jm.ConstantMean.create(1.0, dtype=jnp.float64),
               jnp.asarray(X), jnp.asarray(Y[:, 1:]), capacity=capacity)
    to = convert.to_gp(_flat(jo), kernels.MaternFiveHalves.create(**F64),
                       means.DataMean.create(**F64), device="cpu")
    tc = convert.to_gp(_flat(jc), kernels.Exp.create(**F64),
                       means.ConstantMean.create(1.0, **F64), device="cpu")
    return jo, jc, to, tc


def test_eci_equals_reference():
    """ECI over a (q, d) batch against the reference's per point, on the
    same two GPs; Pf lies in [0, 1] and is 1 over an empty constraint
    GP; f_max defaults to the best prediction."""
    rng = np.random.default_rng(5)
    jo, jc, to, tc = _gp_pairs(rng)
    Xq = rng.uniform(size=(7, 2))
    eci = jax.jit(jax.vmap(lambda x: JECI(jitter=0.01)(jo, jc, x)))
    want = np.asarray(eci(jnp.asarray(Xq)))
    got = ECI(jitter=0.01)(to, tc, torch.from_numpy(Xq))
    assert got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * max(np.abs(want).max(), 1.0))
    pf = ECI.feasibility(tc, torch.from_numpy(Xq))
    assert bool(((pf >= 0) & (pf <= 1)).all()) and bool((pf < 1).any())
    empty = tgp.empty(kernels.Exp.create(**F64),
                      means.ConstantMean.create(1.0, **F64), 2, **F64)
    assert bool((ECI.feasibility(empty, torch.from_numpy(Xq)) == 1).all())


class _FromSweep:
    """A port RandomRestarts that takes the reference's sweep points."""

    def __init__(self, opt, sweep):
        self.opt, self.sweep = opt, torch.from_numpy(np.array(sweep))

    def __call__(self, fun, init, generator, bounded=True):
        return self.opt.from_sweep(fun, init, self.sweep.to(init.dtype),
                                   bounded, generator=generator)


class _Fixed:
    """An init design that returns the reference's drawn points."""

    def __init__(self, X):
        self.X = torch.from_numpy(np.array(X))

    @property
    def count(self):
        return self.X.shape[0]

    def __call__(self, generator, dim, dtype=torch.float32):
        return self.X.to(dtype)


def test_cbo_step_equals_reference():
    """One CBOptimizer iteration from the reference's drawn init design and
    its sweep (RandomRestarts(Rprop(5), 4 restarts seeded from a 32-point
    sweep)): every sample to 1e-9, and the feasibility-aware bests."""
    D, key = 2, jax.random.PRNGKey(5)
    jbo = JCBOptimizer(
        nb_constraints=1, init=JRandomSampling(8), stop=(JMaxIterations(1),),
        acqui_optimizer=JRandomRestarts(sub=JRprop(iterations=5), repeats=4,
                                        sweep_samples=32),
        dtype=jnp.float64)
    jbo.optimize(constrained_2d, dim=D, key=key)
    key, k0 = jax.random.split(key)
    X0 = np.asarray(JRandomSampling(8)(k0, D, dtype=jnp.float64))
    _, k_step = jax.random.split(key)
    sweep = jax.random.uniform(jax.random.split(k_step, 3)[2], (32, D),
                               dtype=jnp.float64)
    bo = CBOptimizer(
        nb_constraints=1, init=_Fixed(X0), stop=(MaxIterations(1),),
        acqui_optimizer=_FromSweep(RandomRestarts(
            sub=Rprop(iterations=5), repeats=4, sweep_samples=32), sweep),
        device="cpu")
    bo.optimize(constrained_2d, D)
    assert len(bo.X) == len(jbo.X) == 9 and bo.iteration == 1
    np.testing.assert_allclose(np.stack(bo.X), np.stack(jbo.X), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(bo._feasible_mask(), jbo._feasible_mask())
    np.testing.assert_allclose(bo.best_sample, jbo.best_sample, atol=1e-9)
    np.testing.assert_allclose(bo.best_observation, jbo.best_observation,
                               atol=1e-12)


def test_cbo_respects_constraint():
    """tests/test_mo_bo.py:86's assertions on the port's loop at its
    defaults (ECI, 64 x Rprop(20) from a 1024-point sweep, f64)."""
    bo = CBOptimizer(nb_constraints=1, stop=(MaxIterations(40),),
                     device="cpu")
    bo.optimize(constrained_f, dim=1, generator=torch.Generator().manual_seed(4))
    assert bo._feasible_mask().any()
    best = float(np.atleast_1d(bo.best_sample)[0])
    assert best <= 0.55
    assert abs(best - 0.5) < 0.15
    # best_observation is the best feasible one
    feas = bo._feasible_mask()
    Y = np.stack(bo.Yobj)[:, 0]
    assert bo.best_observation[0] == Y[feas].max()
    assert len(bo.X) == 10 + 40


def test_cbo_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CBOptimizer(nb_constraints=1)
    bo = CBOptimizer(nb_constraints=2, device="cpu")
    assert bo.dtype == torch.float64 and bo.acqui_optimizer.repeats == 64
    kern, ckern, mean, cmean = bo._models()
    assert isinstance(kern, kernels.MaternFiveHalves)
    assert isinstance(ckern, kernels.Exp)
    assert isinstance(mean, means.DataMean)
    assert isinstance(cmean, means.ConstantMean)
    assert float(cmean.value) == 1.0
