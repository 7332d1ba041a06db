"""The port's random designs, init designs and derivative-free / composed
optimizers against the JAX package's.

torch's Philox and JAX's threefry streams differ, so draws are held by
their properties (range, strata, sigma), and the deterministic parts are
compared exactly: the Halton digits given the reference's shift, the grid,
and the grid designs' values.  Optimizers are compared in f64 (tests/
conftest.py turns on x64) on the same function with the reference's own
sweep and starts handed to the port's deterministic ``from_sweep``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limbo_tpu.bo import init_designs as jinit
from limbo_tpu.opt.compose import Chained as JChained
from limbo_tpu.opt.compose import RandomRestarts as JRandomRestarts
from limbo_tpu.opt.gradient import Rprop as JRprop
from limbo_tpu.opt.search import GridSearch as JGridSearch
from limbo_tpu.utils import random as jrandom
from limbo_tpu_torch.bo import init_designs
from limbo_tpu_torch.opt import (Chained, GridSearch, RandomPoint,
                                 RandomRestarts, RandomSweep, Rprop,
                                 argmax_candidates)
from limbo_tpu_torch.utils import random as trandom

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(11)
DTYPES = [(jnp.float64, torch.float64), (jnp.float32, torch.float32)]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _bumps(X):
    """A smooth multi-modal objective: (d,) -> scalar for the reference,
    (R, d) -> (R,) for the port."""
    mod = jnp if isinstance(X, jax.Array) else torch
    return (-mod.sum((X - 0.3) ** 2, -1)
            + 0.3 * mod.sin(7.0 * mod.sum(X, -1)))


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("n,dim", [(1, 1), (60, 20)])
def test_halton_equals_reference_given_its_shift(jdt, tdt, n, dim):
    """The same digits and the same mod-1 shift, operation for operation:
    equal bits in f64 and in f32."""
    want = jrandom.halton(KEY, n, dim, dtype=jdt)
    shift = np.asarray(jax.random.uniform(KEY, (dim,), dtype=jdt))
    got = trandom._shifted_halton(n, torch.from_numpy(shift.copy()))
    assert got.dtype == tdt
    _same(got, want)
    # the port's own shift: a shifted copy of the same digits
    own = trandom.halton(_gen(3), n, dim, dtype=tdt)
    assert own.shape == (n, dim)
    assert bool(((own >= 0) & (own < 1)).all())


def test_halton_beyond_the_prime_table_is_iid_uniform():
    X = trandom.halton(_gen(), 500, 21, dtype=torch.float64)
    assert X.shape == (500, 21)
    assert bool(((X >= 0) & (X < 1)).all())
    assert abs(float(X.mean()) - 0.5) < 0.02


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_grid_points_and_grid_designs_equal_reference(jdt, tdt):
    """grid_points and GridSampling bit for bit, and RandomSamplingGrid's
    values: exactly the reference's k / bins, every one of them hit."""
    for bins, dim in [(1, 1), (5, 3), (49, 1)]:
        want = jrandom.grid_points(bins, dim, dtype=jdt)
        got = trandom.grid_points(bins, dim, dtype=tdt, device="cpu")
        _same(got, want)
        _same(init_designs.GridSampling(bins=bins, dim=dim)(_gen(), dim,
                                                            dtype=tdt),
              jinit.GridSampling(bins=bins, dim=dim)(KEY, dim, dtype=jdt))
    for bins in (3, 5, 10):
        want = jinit.RandomSamplingGrid(samples=400, bins=bins)(
            KEY, 3, dtype=jdt)
        got = init_designs.RandomSamplingGrid(samples=400, bins=bins)(
            _gen(), 3, dtype=tdt)
        assert got.shape == (400, 3) and got.dtype == tdt
        _same(np.unique(got.numpy()), np.unique(np.asarray(want)))


def test_random_lhs_one_point_per_stratum():
    n, dim = 12, 4
    for X in (trandom.random_lhs(_gen(), n, dim, dtype=torch.float64),
              init_designs.LHS(samples=n)(_gen(1), dim,
                                          dtype=torch.float64)):
        assert X.shape == (n, dim)
        assert bool(((X >= 0) & (X < 1)).all())
        strata = torch.floor(X * n).long()
        for j in range(dim):
            assert sorted(strata[:, j].tolist()) == list(range(n))


def test_random_vectors_range_and_sigma():
    """Bounded draws in [0, 1); unbounded ones N(0, 10^2) (limbo's sigma =
    10): over 20000 draws the mean within 0.3 and the std within 0.2."""
    g = _gen()
    B = trandom.random_vectors(g, 1000, 3, dtype=torch.float64)
    assert B.shape == (1000, 3) and bool(((B >= 0) & (B < 1)).all())
    U = trandom.random_vectors(g, 10000, 2, bounded=False,
                               dtype=torch.float64)
    assert abs(float(U.mean())) < 0.3 and abs(float(U.std()) - 10.0) < 0.2
    v = trandom.random_vector(g, 5, bounded=False)
    assert v.shape == (5,) and v.dtype == torch.float32
    R = init_designs.RandomSampling(samples=7, bounded=False)(
        g, 3, dtype=torch.float64)
    assert R.shape == (7, 3) and float(R.abs().max()) > 1.0


def test_init_design_counts_match_reference():
    pairs = [(init_designs.NoInit(), jinit.NoInit()),
             (init_designs.RandomSampling(17), jinit.RandomSampling(17)),
             (init_designs.RandomSamplingGrid(9, 4),
              jinit.RandomSamplingGrid(9, 4)),
             (init_designs.GridSampling(3, dim=2), jinit.GridSampling(3, 2)),
             (init_designs.LHS(6), jinit.LHS(6))]
    for t, j in pairs:
        assert t.count == j.count
        X = t(_gen(), 2, dtype=torch.float64)
        assert X.dtype == torch.float64 and X.shape[1] == 2
    assert init_designs.NoInit()(_gen(), 3).shape == (0, 3)


def test_grid_search_and_chained_equal_reference():
    """GridSearch, and Chained(GridSearch, Rprop) from the grid's best
    point, f64: the same point and value to 1e-12."""
    init = np.full((2,), 0.5)
    tol = dict(rtol=1e-12, atol=1e-12)
    for jopt, topt in [
            (JGridSearch(bins=6), GridSearch(bins=6)),
            (JChained(subs=(JGridSearch(bins=4), JRprop(iterations=10))),
             Chained(subs=(GridSearch(bins=4), Rprop(iterations=10))))]:
        jres = jax.jit(lambda k: jopt(_bumps, jnp.asarray(init), k, True))(
            KEY)
        tres = topt(_bumps, torch.from_numpy(init), _gen(), True)
        np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), **tol)
        np.testing.assert_allclose(float(tres.value), float(jres.value),
                                   **tol)


@pytest.mark.parametrize("kw", [
    dict(sweep_kind="halton", polish_k=2, polish_steps=4),
    dict(sweep_kind="halton", seed_from_sweep=False),
    dict(sweep_kind="uniform", polish_k=3, polish_steps=2)])
def test_random_restarts_knobs_from_reference_draws(kw):
    """RandomRestarts with a Halton sweep, unseeded starts, and the polish
    of the best carries, given the reference's sweep and starts: the same
    point and value (f64, 1e-10)."""
    d, R, S = 3, 6, 40
    jopt = JRandomRestarts(sub=JRprop(iterations=6), repeats=R,
                           sweep_samples=S, **kw)
    init = jnp.full((d,), 0.5)
    jres = jax.jit(lambda k: jopt(_bumps, init, k, True))(KEY)
    k_init, _, k_sweep = jax.random.split(KEY, 3)
    sweep = (jrandom.halton(k_sweep, S, d, dtype=init.dtype)
             if kw["sweep_kind"] == "halton"
             else jax.random.uniform(k_sweep, (S, d), dtype=init.dtype))
    starts = jax.random.uniform(k_init, (R, d), dtype=init.dtype)
    topt = RandomRestarts(sub=Rprop(iterations=6), repeats=R,
                          sweep_samples=S, **kw)
    tres = topt.from_sweep(_bumps, torch.from_numpy(np.array(init)),
                           torch.from_numpy(np.array(sweep)), True,
                           starts=torch.from_numpy(np.array(starts)))
    tol = dict(rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), **tol)
    np.testing.assert_allclose(float(tres.value), float(jres.value), **tol)
    # __call__ draws its own sweep and starts
    res = topt(_bumps, torch.full((d,), 0.5, dtype=torch.float64), _gen(),
               True)
    assert res.x.shape == (d,) and bool(torch.isfinite(res.value))


def test_polish_needs_a_resumable_sub_optimizer():
    opt = RandomRestarts(sub=GridSearch(bins=2), repeats=2, sweep_samples=4,
                         polish_k=1, polish_steps=2)
    with pytest.raises(ValueError, match="resumable"):
        opt(_bumps, torch.full((2,), 0.5, dtype=torch.float64), _gen(), True)


def test_random_point_and_sweep():
    init = torch.full((3,), 0.5, dtype=torch.float64)
    p = RandomPoint()(_bumps, init, _gen(), True)
    assert p.x.shape == (3,) and bool(((p.x >= 0) & (p.x < 1)).all())
    assert float(p.value) == float(_bumps(p.x[None, :])[0])
    s = RandomSweep(samples=200)(_bumps, init, _gen(), True)
    X = trandom.random_vectors(_gen(), 200, 3, dtype=torch.float64)
    best = argmax_candidates(_bumps, X)
    assert torch.equal(s.x, best.x) and float(s.value) == float(best.value)
    assert float(s.value) == float(_bumps(X).max())
