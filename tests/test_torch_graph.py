"""The captured BO iteration (``limbo_tpu_torch/bo/graph.py``),
``BOptimizer.optimize_jit`` and ``bench_torch.py`` on the CPU, where the
step runs eagerly (the card's replays are tests/test_torch_cuda.py's).

* The step over device counts and in-place state against the host-int
  path (plain ``add_sample_cached`` calls deciding their own flush), bit
  for bit in f64 over 12 deferred appends with defer_m = 8.
* optimize_jit with the reference's assertions (tests/test_boptimizer.py:
  82-192): the full loop, with hp-opt, the query cache, the bf16 mirror and
  the cached append modes past a flush; the freeze mask of a stop
  criterion; the options it refuses.
* MaxPredictedValue.device_stop's decision as a 0-d bool tensor, and
  GP_UCB's beta from a device count, against the reference.
* bench_torch's function at n = 256: its JSON line and its guard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
import limbo_tpu.acqui as jacq
from limbo_tpu.bo import MaxPredictedValue as JMaxPredictedValue
from limbo_tpu.kernels import MaternFiveHalves as JMatern52
from limbo_tpu.means import DataMean as JDataMean
from limbo_tpu.models import gp as jgp
from limbo_tpu.opt.compose import RandomRestarts as JRandomRestarts
from limbo_tpu.opt.gradient import Rprop as JRprop
from limbo_tpu_torch import acqui, kernels, means
from limbo_tpu_torch.bo import (BOptimizer, MaxIterations,
                                MaxPredictedValue, RandomSampling)
from limbo_tpu_torch.bo.graph import BOStep
from limbo_tpu_torch.models import gp as tgp
from limbo_tpu_torch.models.hp_opt import KernelLFOpt
from limbo_tpu_torch.opt import RandomRestarts, Rprop
from limbo_tpu_torch.utils import convert

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
OPT_X = 0.25


def _bowl(x):
    return -torch.sum((x - OPT_X) ** 2).reshape(1)


def _make_bo(iters, hp=False, **kw):
    """The reference test's make_bo (tests/test_boptimizer.py:28-43) on the
    port, in f64 on the CPU."""
    if hp:
        kw.update(kernel=kernels.SquaredExpARD.create(dim=2, **F64),
                  hp_opt=KernelLFOpt(optimizer=Rprop(iterations=50)),
                  hp_period=10)
    return BOptimizer(acqui=acqui.UCB(alpha=0.5), init=RandomSampling(6),
                      stop=(MaxIterations(iters),),
                      acqui_optimizer=RandomRestarts(
                          sub=Rprop(iterations=40), repeats=8,
                          sweep_samples=256),
                      stats_enabled=False, **F64, **kw)


# ---------------------------------------------------------------------------
# the step over device counts
# ---------------------------------------------------------------------------

def _state(n=40, capacity=64, d=2, defer_m=8):
    g = torch.Generator().manual_seed(2)
    X = torch.rand((n, d), generator=g, dtype=torch.float64)
    Y = torch.sin(3.0 * X.sum(dim=1, keepdim=True))
    gp = tgp.fit(kernels.SquaredExpARD.create(dim=d, **F64),
                 means.DataMean.create(**F64), X, Y, capacity=capacity,
                 device="cpu")
    return gp, tgp.QueryCache.build(gp, with_Linv=True, defer_m=defer_m)


def _propose(gen):
    opt = RandomRestarts(sub=Rprop(iterations=5), repeats=8,
                         sweep_samples=32)

    def propose(model, it):
        return opt(lambda Z: acqui.UCB()(model, Z),
                   torch.full((2,), 0.5, dtype=torch.float64), gen, True).x
    return propose


def _objective(x):
    return torch.sin(3.0 * torch.sum(x))[None]


def test_counter_step_equals_the_host_int_path():
    """12 deferred appends (a flush at the 8th): BOStep, its rows written
    at the device counts, its flush forced by the host's count, its state
    written back in place, against plain add_sample_cached calls that
    decide their own flush; the same bits in every tensor, and the device
    counts equal to the host's after every step."""
    gp, cache = _state()
    gen = torch.Generator().manual_seed(7)
    step = BOStep(gp, cache, _propose(gen), _objective, gen,
                  fast_update="deferred")
    gp2, cache2 = _state()
    gen2 = torch.Generator().manual_seed(7)
    propose = _propose(gen2)
    for k in range(12):
        step.step()
        x = propose(tgp.CachedGPView(gp2, cache2), None)
        gp2, cache2 = tgp.add_sample_cached(gp2, cache2, x, _objective(x),
                                            fast_update="deferred")
        assert step.gp.n == gp2.n == 41 + k
        assert step.cache.base_n == cache2.base_n == (48 if k >= 7 else 40)
        assert int(step.gp.n_dev) == step.gp.n
        assert int(step.cache.base_n_dev) == step.cache.base_n
    assert step.graphs.graphs is None          # the CPU runs it eagerly
    for name in ("x", "y", "L", "alpha", "n_dev"):
        assert torch.equal(getattr(step.gp, name), getattr(gp2, name)), name
    assert torch.equal(step.gp.mean.value, gp2.mean.value)
    for name in ("Kinv", "Linv", "P", "ay", "u_ones", "base_n_dev"):
        assert torch.equal(getattr(step.cache, name),
                           getattr(cache2, name)), name
    assert int(step.it) == 12


def test_step_refits_a_bad_exact_append():
    """The exact append's finiteness flag: a non-finite append (a NaN
    objective) refits from the stored data, as add_sample does."""
    gp, _ = _state(n=10, capacity=16)
    gen = torch.Generator().manual_seed(1)
    step = BOStep(gp, None, _propose(gen),
                  lambda x: torch.full((1,), torch.nan, dtype=x.dtype), gen)
    step.step()
    assert not bool(step.ok) and step.gp.n == 11
    ref = tgp.recompute(step.gp)
    assert torch.equal(step.gp.L, ref.L)


# ---------------------------------------------------------------------------
# optimize_jit: the reference's assertions
# ---------------------------------------------------------------------------

def test_optimize_jit_full_loop():
    state, hist = _make_bo(30).optimize_jit(_bowl, dim_in=2)
    assert hist["samples"].shape == (30, 2)
    assert float(hist["best"][-1]) > -1e-2
    np.testing.assert_allclose(state.best_sample, [OPT_X, OPT_X], atol=0.1)
    assert bool((torch.diff(hist["best"]) >= -1e-12).all())
    assert int(hist["effective_iterations"]) == 30
    assert state.gp.n == 36 and state.iteration == 30
    # the history is the GP's data, the best its best aggregate
    assert torch.equal(hist["samples"], state.gp.x[6:36])
    assert torch.equal(hist["observations"], state.gp.y[6:36])
    assert float(hist["best"][-1]) == state.best_value


def test_optimize_jit_with_hp_opt():
    state, hist = _make_bo(25, hp=True).optimize_jit(_bowl, dim_in=2)
    assert float(hist["best"][-1]) > -5e-2
    assert not torch.equal(state.gp.kernel.params, torch.zeros(3, **F64))


@pytest.mark.parametrize("kw", [
    dict(), dict(cache_query_dtype=torch.bfloat16),
    dict(cache_fast_update="linv"),
    dict(cache_fast_update="deferred", cache_defer_m=8)],
    ids=["solve", "bf16_mirror", "linv", "deferred"])
def test_optimize_jit_query_cache(kw):
    """The query-cache loop (tests/test_boptimizer.py:103-112, 115-133,
    164-181); "deferred" flushes at 8, 16 and 24."""
    state, hist = _make_bo(25, use_query_cache=True,
                           **kw).optimize_jit(_bowl, dim_in=2)
    assert float(hist["best"][-1]) > -1e-2
    assert state.cache is not None
    if "cache_defer_m" in kw:
        assert state.cache.base_n == 30
    if "cache_query_dtype" in kw:
        return
    # the cache's posterior is the fit's of the same data
    ref = tgp.fit(state.gp.kernel, state.gp.mean, state.gp.x[:31],
                  state.gp.y[:31], capacity=state.gp.capacity, device="cpu")
    Xq = torch.rand((5, 2), dtype=torch.float64)
    for a, b in zip(tgp.query_cached(state.gp, state.cache, Xq),
                    ref.query(Xq)):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)


def test_optimize_jit_freeze_mask():
    """A stop criterion freezes the loop (the reference's lax.cond): its
    decision after the first iteration stops the run, the later rows are
    NaN with -inf aggregates, and the state holds one new sample."""
    def f(x):
        return 1.0 - torch.sum((x - OPT_X) ** 2).reshape(1)

    bo = _make_bo(8)
    bo.stop = (MaxIterations(8), MaxPredictedValue(ratio=0.0))
    state, hist = bo.optimize_jit(f, dim_in=2)
    assert int(hist["effective_iterations"]) == 1 and state.gp.n == 7
    assert bool(torch.isfinite(hist["samples"][0]).all())
    assert bool(torch.isnan(hist["samples"][1:]).all())
    assert bool(torch.isnan(hist["observations"][1:]).all())
    assert bool((hist["best"] == hist["best"][0]).all())
    assert state.iteration == 8
    with pytest.raises(TypeError, match="device_stop"):
        bo.stop = (MaxIterations(3), lambda s: False)
        bo.optimize_jit(f, dim_in=2)
    bo = _make_bo(3)
    bo.model_type = "spgp"
    with pytest.raises(NotImplementedError, match="exact-GP"):
        bo.optimize_jit(f, dim_in=2)


# ---------------------------------------------------------------------------
# against the reference: device_stop, GP_UCB
# ---------------------------------------------------------------------------

def test_device_stop_is_a_device_tensor_with_the_reference_decision():
    """MaxPredictedValue.device_stop from the reference's sweep returns a
    0-d bool tensor with the reference's decision just below and above
    0.9 x the model maximum; __call__ keeps a bool."""
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(12, 2))
    Y = 1.0 - np.sum((X - 0.3) ** 2, axis=1, keepdims=True)
    gj = jgp.fit(JMatern52.create(dtype=jnp.float64),
                 JDataMean.create(dtype=jnp.float64), jnp.asarray(X),
                 jnp.asarray(Y), capacity=16)
    flat = {"/".join(str(p) for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(gj)[0]}
    gt = convert.to_gp(flat, kernels.MaternFiveHalves.create(**F64),
                       means.DataMean.create(**F64), device="cpu")
    key = jax.random.PRNGKey(7)
    sweep = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.split(key, 3)[2], (64, 2))))
    jstop = JMaxPredictedValue(ratio=0.9, optimizer=JRandomRestarts(
        sub=JRprop(iterations=3), repeats=4, sweep_samples=64))
    topt = RandomRestarts(sub=Rprop(iterations=3), repeats=4,
                          sweep_samples=64)
    tmax = float(topt.from_sweep(lambda Z: tgp.query(gt, Z)[0][:, 0],
                                 torch.full((2,), 0.5, **F64), sweep).value)

    class _FromSweep:
        def __call__(self, fun, init, generator, bounded=True):
            return topt.from_sweep(fun, init, sweep, bounded)

    tstop = MaxPredictedValue(ratio=0.9, optimizer=_FromSweep())
    jdecide = jax.jit(lambda b: jstop.device_stop(gj, b, key,
                                                  jacq.FirstElem))
    for scale in (0.9 * (1 - 1e-9), 0.9 * (1 + 1e-9)):
        best = torch.tensor(tmax * scale, dtype=torch.float64)
        got = tstop.device_stop(gt, best, None, acqui.FirstElem)
        want = bool(jdecide(jnp.asarray(tmax * scale)))
        assert torch.is_tensor(got) and got.dtype == torch.bool
        assert got.shape == () and bool(got) == want == (scale > 0.9)


def test_gp_ucb_beta_from_a_device_count_equals_reference():
    """GP-UCB with the iteration as a tensor (the captured loop's count):
    beta in the query's dtype, as the reference's traced formula."""
    rng = np.random.default_rng(4)
    X = rng.uniform(size=(9, 3)).astype(np.float32)
    Y = np.sin(X.sum(axis=1, keepdims=True))
    gj = jgp.fit(JMatern52.create(), JDataMean.create(), jnp.asarray(X),
                 jnp.asarray(Y), capacity=16)
    flat = {"/".join(str(p) for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(gj)[0]}
    gt = convert.to_gp(flat, kernels.MaternFiveHalves.create(device="cpu"),
                       means.DataMean.create(device="cpu"), device="cpu")
    Xq = rng.uniform(size=(4, 3)).astype(np.float32)
    jucb = jax.jit(jax.vmap(lambda x, it: jacq.GP_UCB()(gj, x, iteration=it),
                            in_axes=(0, None)))
    for it in (0, 1, 7, 150):
        want = np.asarray(jucb(jnp.asarray(Xq), jnp.int32(it)))
        got = acqui.GP_UCB()(gt, torch.from_numpy(Xq),
                             iteration=torch.tensor(it))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# bench_torch
# ---------------------------------------------------------------------------

def test_bench_torch_json_line_and_guard():
    """bench_torch's function at n = 256 on the CPU (both modes eager):
    its JSON line's keys, and its guard on a non-finite factor."""
    res = bench_torch.bench(n=256, iters=1, device="cpu")
    assert res["n_final"] == 256 + 1 + 2 * bench_torch.GROUPS
    line = bench_torch.result_line(res, 2.0, "a card", 256)
    assert set(line) == {"metric", "value", "unit", "uncaptured",
                         "vs_baseline"}
    assert line["metric"] == "torch_bo_iterations_per_s_n10k"
    assert line["value"] > 0 and line["uncaptured"] > 0
    assert line["vs_baseline"] == line["value"] / 2.0
    assert "a card" in line["unit"] and "TF32 off" in line["unit"]
    step, _, _ = bench_torch.make_step(256, 8, 1, "cpu")
    bench_torch.check_finite(step.gp)
    step.gp.L[3, 0] = torch.nan
    with pytest.raises(AssertionError, match="non-finite"):
        bench_torch.check_finite(step.gp)
