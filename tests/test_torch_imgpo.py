"""IMGPO against the JAX package's: whole runs on the reference tests'
problems (tests/test_mo_bo.py:107 and :137), which draw nothing at random,
so the port must take the reference's decisions one for one: the same
sample sequence (to 1e-9; both fit and query their GP in f64 on the CPU),
the same M and the same best value, and then the reference tests' own
assertions.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limbo_tpu.benchmarks.functions import BRANIN as JBRANIN
from limbo_tpu.bo.imgpo import IMGPO as JIMGPO
from limbo_tpu_torch.bo.imgpo import IMGPO
from limbo_tpu_torch.models import gp as tgp
from limbo_tpu_torch.models.hp_opt import KernelLFOpt
from limbo_tpu_torch.opt import Rprop

torch.set_num_threads(1)


def quad(x):
    return -np.sum((np.asarray(x) - 0.3) ** 2)


_jbranin = JBRANIN.as_max_objective()


def branin(x):
    return np.asarray(_jbranin(jnp.asarray(x)))


@pytest.mark.parametrize("name,f,max_evals", [("quad", quad, 40),
                                              ("branin", branin, 45)],
                         ids=["quad", "branin"])
def test_imgpo_run_equals_reference(name, f, max_evals):
    ref = JIMGPO(max_evals=max_evals, dtype=jnp.float64).optimize(f, dim=2)
    opt = IMGPO(max_evals=max_evals, device="cpu").optimize(f, dim=2)
    assert len(opt.X) == len(ref.X)
    np.testing.assert_allclose(np.stack(opt.X), np.stack(ref.X), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(opt.Y, ref.Y, rtol=1e-12)
    assert opt.M == ref.M
    assert opt.best_value == ref.best_value
    # the reference tests' assertions (tests/test_mo_bo.py:107-151)
    assert len(opt.Y) <= max_evals
    if name == "quad":
        assert opt.best_value > -2e-3
        np.testing.assert_allclose(opt.best_sample, [0.3, 0.3], atol=0.06)
    else:
        assert JBRANIN.accuracy(-opt.best_value) < 0.1
        assert opt.M > 1         # the GP screen replaced an evaluation


def test_imgpo_bound_is_ucb_imgpo():
    """The screen's bound is acqui.experimental.UCB_IMGPO's: mu +
    (sqrt(2 log(pi^2 M^2 / (12 nu))) + 0.2) sigma on the run's GP."""
    opt = IMGPO(max_evals=12, nu=0.1, device="cpu").optimize(quad, dim=2)
    gp = opt._fit_gp(64)
    X = np.random.default_rng(0).uniform(size=(5, 2))
    mu, var = tgp.query(gp, torch.from_numpy(X))
    for M in (1, 7):
        w = math.sqrt(2.0 * math.log(math.pi ** 2 * M ** 2 / (12 * 0.1)))
        want = (mu[:, 0] + (w + 0.2) * torch.sqrt(var)).numpy()
        np.testing.assert_allclose(opt._ucb(gp, X, M), want, rtol=1e-15)
        assert opt._varsigma(M) == w + 0.2


def test_imgpo_final_hp_opt():
    """The optional final hp-opt (imgpo.hpp:379-380) learns the kernel of
    the last GP from the run's generator."""
    hp = KernelLFOpt(optimizer=Rprop(iterations=5))
    opt = IMGPO(max_evals=15, hp_opt=hp, device="cpu")
    opt.optimize(quad, dim=2, generator=torch.Generator().manual_seed(0))
    assert opt._final_gp.n == len(opt.X)
    assert not torch.equal(opt._final_gp.kernel.params,
                           opt._fit_gp(64).kernel.params)


def test_imgpo_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IMGPO()
    assert IMGPO(device="cpu").dtype == torch.float64
