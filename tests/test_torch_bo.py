"""The port's BO entry point (``limbo_tpu_torch.bo``) against the JAX
package's, and its own loop on the CPU.

Against the reference, in f64 (tests/conftest.py turns on x64): the
capacity buckets (pure arithmetic on a reference BOptimizer that never
runs), MaxPredictedValue's decision, one ask -> tell step from the
reference's init points with the reference's sweep injected, every stats
writer's lines, and the GP accessors.  No test runs the reference's
``optimize`` loop or ``optimize_jit`` (tests/test_torch_graph.py runs the
port's).  The port's own loop is run on the CPU at a small size:
best-so-far, resume, NaN guards, ask/tell against optimize, the cached
append modes, and the options' argument checks.  Every option ported in
the last slice (the "refined", True and lite cache appends, the spgp and
iterative families, max_model_points) takes one ask -> tell step against
the reference's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limbo_tpu.acqui as jacq
from limbo_tpu.bo import BOptimizer as JBOptimizer
from limbo_tpu.bo import BOState as JBOState
from limbo_tpu.bo import MaxIterations as JMaxIterations
from limbo_tpu.bo import MaxPredictedValue as JMaxPredictedValue
from limbo_tpu.bo import RandomSampling as JRandomSampling
from limbo_tpu.bo import stats as jstats
from limbo_tpu.kernels import MaternFiveHalves as JMatern52
from limbo_tpu.means import DataMean as JDataMean
from limbo_tpu.models import gp as jgp
from limbo_tpu.opt.compose import RandomRestarts as JRandomRestarts
from limbo_tpu.opt.gradient import Rprop as JRprop
import limbo_tpu_torch.bo as tbo
from limbo_tpu_torch import acqui, kernels, means
from limbo_tpu_torch.bo import (BOptimizer, BOptimizerHPOpt, BOState,
                                EvaluationError, MaxIterations,
                                MaxPredictedValue, RandomSampling, stats)
from limbo_tpu_torch import models as tbo_models
from limbo_tpu_torch.models import gp as tgp
from limbo_tpu_torch.opt import RandomRestarts, Rprop
from limbo_tpu_torch.utils import convert

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(7)
_jfit = jax.jit(jgp.fit, static_argnames=("capacity",))
F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-9, atol=1e-9)
D = 2


def quad(x):
    x = np.asarray(x, dtype=np.float64)
    return np.array([-np.sum((x - 0.3) ** 2) + 0.2 * np.sin(5.0 * x[0])])


def _flat(tree):
    return {"/".join(str(p) for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


class _FromSweep:
    """A port RandomRestarts that takes the reference's sweep points
    instead of drawing its own."""

    def __init__(self, opt, sweep):
        self.opt, self.sweep = opt, torch.from_numpy(np.array(sweep))

    def __call__(self, fun, init, generator, bounded=True):
        return self.opt.from_sweep(fun, init, self.sweep.to(init.dtype),
                                   bounded, generator=generator)


def _gp_pair(n=12, capacity=64):
    """(reference GP, port GP): Matern-5/2 + DataMean fitted by the
    reference on seeded data, carried across with utils/convert.py."""
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(n, D))
    Y = np.stack([quad(x) for x in X])
    gj = _jfit(
        JMatern52.create(dtype=jnp.float64),
        JDataMean.create(dtype=jnp.float64), jnp.asarray(X), jnp.asarray(Y),
        capacity=capacity)
    gt = convert.to_gp(_flat(gj), kernels.MaternFiveHalves.create(**F64),
                       means.DataMean.create(**F64), device="cpu")
    return gj, gt


def _small(**kw):
    """A port BOptimizer at a small optimizer configuration on the CPU."""
    kw.setdefault("acqui_optimizer", RandomRestarts(sub=Rprop(iterations=4),
                                                    repeats=4,
                                                    sweep_samples=32))
    kw.setdefault("init", RandomSampling(4))
    kw.setdefault("stop", (MaxIterations(5),))
    return BOptimizer(device="cpu", dtype=torch.float64, **kw)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_capacity_buckets_equal_reference():
    for count in (0, 4, 10, 300, 4096):
        for iters in (1, 30, 190, 245, 2000):
            jbo = JBOptimizer(init=JRandomSampling(count),
                              stop=(JMaxIterations(iters),))
            tbo_ = BOptimizer(init=RandomSampling(count),
                              stop=(MaxIterations(iters),), device="cpu")
            for extra in (0, 1, 55, 1000):
                assert tbo_._capacity(extra) == jbo._capacity(extra)
    assert BOptimizer(device="cpu")._capacity() == 256
    assert BOptimizer(device="cpu", stop=())._max_iterations() == 190


def test_max_predicted_value_same_decision():
    """From the reference's sweep, the stop decision at best values just
    below and just above ratio x the model maximum (1 -+ 1e-9 relative, so
    the two maxima agree to that), and far from it."""
    gj, gt = _gp_pair()
    jstop = JMaxPredictedValue(ratio=0.9, optimizer=JRandomRestarts(
        sub=JRprop(iterations=8), repeats=4, sweep_samples=64))
    sweep = jax.random.uniform(jax.random.split(KEY, 3)[2], (64, D))
    topt = _FromSweep(RandomRestarts(sub=Rprop(iterations=8), repeats=4,
                                     sweep_samples=64), sweep)
    tstop = MaxPredictedValue(ratio=0.9, optimizer=topt)
    tmax = float(topt(lambda X: tgp.query(gt, X)[0][:, 0],
                      torch.full((D,), 0.5, dtype=torch.float64), None).value)
    jdecide = jax.jit(lambda g, b, k: jstop.device_stop(g, b, k,
                                                        jacq.FirstElem))
    for scale in (0.5, 0.9 * (1 - 1e-9), 0.9 * (1 + 1e-9), 1.5):
        best = tmax * scale
        want = bool(jdecide(gj, jnp.asarray(best), KEY))
        got = tstop.device_stop(gt, best, None, acqui.FirstElem)
        assert got == want == (scale > 0.9), (scale, got, want)
    # the port's own search of the same model finds the same maximum
    st = BOState(gp=gt, generator=torch.Generator().manual_seed(0))
    assert MaxPredictedValue(ratio=0.0)(st)


def test_ask_tell_step_equals_reference():
    """From the reference's init points, with its sweep injected: the
    proposal, its acquisition value and predicted mean, then the posterior
    after tell(), f64 to 1e-9."""
    jopt = JRandomRestarts(sub=JRprop(iterations=5), repeats=4,
                           sweep_samples=32)
    jbo = JBOptimizer(acqui_optimizer=jopt, init=JRandomSampling(6),
                      stop=(JMaxIterations(3),), dtype=jnp.float64)
    js = jbo.init_state(D, key=KEY)
    X0 = [np.asarray(x) for x in js.pending_init]
    for x in X0:
        js = jbo.tell(js, x, quad(x))
    _, k_prop = jax.random.split(js.key)
    sweep = jax.random.uniform(jax.random.split(k_prop, 3)[2], (32, D))
    jx = jbo.ask(js)
    js = jbo.tell(js, jx, quad(jx))

    bo = _small(acqui_optimizer=_FromSweep(
        RandomRestarts(sub=Rprop(iterations=5), repeats=4, sweep_samples=32),
        sweep), init=RandomSampling(6), stop=(MaxIterations(3),))
    st = bo.init_state(D, generator=torch.Generator().manual_seed(0))
    for x in X0:
        assert bo.ask(st).shape == (D,)
        st = bo.tell(st, x, quad(x))
    tx = bo.ask(st)
    np.testing.assert_allclose(tx, np.asarray(jx), **TOL)
    np.testing.assert_allclose(st.last_acqui_value, js.last_acqui_value,
                               **TOL)
    np.testing.assert_allclose(st.last_prediction, js.last_prediction, **TOL)
    st = bo.tell(st, tx, quad(tx))
    assert st.iteration == js.iteration == 1 and st.gp.n == int(js.gp.n)
    Xq = np.random.default_rng(1).uniform(size=(9, D))
    jmu, jvar = jax.jit(jgp.query)(js.gp, jnp.asarray(Xq))
    tmu, tvar = st.gp.query(torch.from_numpy(Xq))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **TOL)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), **TOL)
    assert st.best_value == js.best_value
    np.testing.assert_array_equal(st.best_sample, js.best_sample)


def test_stats_writers_write_the_reference_lines(tmp_path, capsys):
    """All 13 writers on the same state (a reference GP carried across),
    file by file and line by line; the console line to stdout."""
    gj, gt = _gp_pair()
    last = dict(iteration=3, total_iterations=3,
                last_sample=np.array([0.25, 0.75]),
                last_observation=np.array([-0.125]),
                last_acqui_value=0.5 + 1e-7,
                last_prediction=np.array([-0.1]))
    js = JBOState(gp=gj, key=KEY, **last)
    ts = BOState(gp=gt, generator=torch.Generator(), **last)
    names = ["Samples", "Observations", "AggregatedObservations",
             "BestSamples", "BestObservations", "BestAggregatedObservations",
             "GPLikelihood", "GPKernelHParams", "GPMeanHParams",
             "GPAcquisitions", "GPPredictionDifferences"]
    for side, mod, state in (("ref", jstats, js), ("port", stats, ts)):
        out = tmp_path / side
        out.mkdir()
        sink = type("Sink", (), dict(stats_enabled=True, res_dir=str(out)))
        for name in names:
            getattr(mod, name)()(sink, state)
        mod.GPGrid(bins=3)(sink, state)
        mod.ConsoleSummary()(sink, state)
    ref, port = sorted(os.listdir(tmp_path / "ref")), sorted(
        os.listdir(tmp_path / "port"))
    assert port == ref and len(ref) == 12
    for name in ref:
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "ref" / name).read_text()), name
    console = capsys.readouterr().out.splitlines()
    assert len(console) == 2 and console[0] == console[1]
    assert len([c for c in vars(stats).values() if isinstance(c, type)
                and issubclass(c, stats.StatBase)
                and c is not stats.StatBase]) == 13


def test_gp_accessors_equal_reference():
    gj, gt = _gp_pair()
    Xq = np.random.default_rng(2).uniform(size=(5, D))
    assert gt.nb_samples == int(gj.nb_samples) == 12
    for t, j in ((gt.mu(torch.from_numpy(Xq)), gj.mu(jnp.asarray(Xq))),
                 (gt.sigma_sq(torch.from_numpy(Xq)),
                  gj.sigma_sq(jnp.asarray(Xq)))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


# ---------------------------------------------------------------------------
# the port's own loop on the CPU
# ---------------------------------------------------------------------------

def test_optimize_best_value_is_the_best_observation():
    st = _small().optimize(quad, D)
    assert st.iteration == st.total_iterations == 5 and st.gp.n == 9
    obs = st.gp.y[:st.gp.n, 0].numpy()
    assert st.best_value == obs.max()
    assert st.best_observation[0] == obs.max()
    np.testing.assert_array_equal(st.best_sample,
                                  st.gp.x[int(obs.argmax())].numpy())
    assert quad(st.best_sample)[0] == st.best_value
    X = st.gp.x[:st.gp.n].numpy()
    assert np.all((X >= 0) & (X <= 1))
    np.testing.assert_array_equal(st.last_sample, X[-1])
    np.testing.assert_array_equal(st.last_observation, quad(X[-1]))


@pytest.mark.parametrize("fast", [None, "deferred"])
def test_resume_continues_and_grows(fast):
    """reset=False keeps the samples, restarts the run's counter, continues
    total_iterations, and grows the buffers past the first capacity
    (4 + 250 + 1 fits 256; after 4 + 3 samples the next run needs 262);
    a query cache is rebuilt at the new capacity."""
    cached = dict(use_query_cache=True, cache_fast_update=fast,
                  cache_defer_m=2) if fast else {}
    bo = _small(stop=(MaxIterations(250), lambda s: s.iteration >= 3),
                **cached)
    st = bo.optimize(quad, D)
    assert st.gp.capacity == 256 and st.gp.n == 7
    first = st.gp.x[:7].clone()
    st = bo.optimize(quad, D, reset=False, state=st)
    assert st.gp.capacity == 512 and st.gp.n == 10
    assert st.iteration == 3 and st.total_iterations == 6
    assert torch.equal(st.gp.x[:7], first)
    # the grown GP is the fit of its data
    ref = tgp.fit(st.gp.kernel, st.gp.mean, st.gp.x[:10], st.gp.y[:10],
                  capacity=512, device="cpu")
    Xq = torch.rand((6, D), dtype=torch.float64)
    for a, b in zip(st.gp.query(Xq), ref.query(Xq)):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)
    if fast:
        assert st.cache.Kinv.shape == (512, 512)
        for a, b in zip(tgp.query_cached(st.gp, st.cache, Xq), ref.query(Xq)):
            torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)


def test_resume_with_another_aggregator_keeps_the_state_aggregator():
    """As the reference: on reset=False the state keeps its first run's
    aggregator for best-so-far, and the new call's aggregator drives the
    proposals."""
    calls = []

    def neg(mu):
        calls.append(mu.shape[0])
        return -mu[:, 0]

    bo = _small(stop=(MaxIterations(3),))
    st = bo.optimize(quad, D)
    assert not calls
    st = bo.optimize(quad, D, reset=False, state=st, aggregator=neg)
    assert calls and st.total_iterations == 6
    assert st.aggregator is acqui.FirstElem
    obs = st.gp.y[:st.gp.n, 0].numpy()
    assert st.best_value == obs.max() and st.best_index == obs.argmax()


def test_nan_observation_raises():
    with pytest.raises(EvaluationError):
        _small().optimize(lambda x: np.array([np.nan]), D)
    bo = _small()
    st = bo.init_state(D)
    with pytest.raises(EvaluationError):
        bo.tell(st, bo.ask(st), [np.inf])


def test_ask_tell_matches_optimize_on_the_same_draws():
    bo = _small(acqui=acqui.EI())
    ran = bo.optimize(quad, D, generator=torch.Generator().manual_seed(5))
    st = bo.init_state(D, generator=torch.Generator().manual_seed(5))
    while not bo._stopped(st):
        x = bo.ask(st)
        st = bo.tell(st, x, quad(x))
    n = ran.gp.n
    assert st.gp.n == n and st.total_iterations == ran.total_iterations
    assert torch.equal(st.gp.x[:n], ran.gp.x[:n])
    assert torch.equal(st.gp.y[:n], ran.gp.y[:n])
    assert st.last_acqui_value == ran.last_acqui_value


@pytest.mark.parametrize("fast", [False, "linv", "deferred"])
def test_cached_loop_posterior_equals_a_fresh_fit(fast):
    """The query-cache loop (appends, a refresh at 3, hp-opt at 4) against
    an uncached fit of the same data, f64 to 1e-8."""
    bo = _small(use_query_cache=True, cache_fast_update=fast,
                cache_defer_m=2, cache_refresh_period=3,
                hp_opt=tbo.default_hp_opt(iterations=3, repeats=2),
                hp_period=4)
    st = bo.optimize(quad, D)
    assert st.cache is not None and st.gp.n == 9
    ref = tgp.fit(st.gp.kernel, st.gp.mean, st.gp.x[:9], st.gp.y[:9],
                  capacity=st.gp.capacity, device="cpu")
    Xq = torch.rand((6, D), dtype=torch.float64)
    for a, b in zip(tgp.query_cached(st.gp, st.cache, Xq), ref.query(Xq)):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)


def test_stats_written_by_the_loop(tmp_path):
    bo = _small(stats=(stats.Samples(), stats.BestAggregatedObservations(),
                       stats.GPGrid(bins=2)), res_base_dir=str(tmp_path))
    bo.optimize(quad, D)
    data = np.loadtxt(os.path.join(bo.res_dir, "samples.dat"))
    np.testing.assert_array_equal(data[:, 0], [1, 2, 3, 4, 5])
    best = np.loadtxt(os.path.join(bo.res_dir,
                                   "best_aggregated_observations.dat"))
    assert np.all(np.diff(best[:, 1]) >= 0)
    assert os.path.exists(os.path.join(bo.res_dir, "gp_5.dat"))
    assert _small(stats=(stats.Samples(),), res_base_dir=str(tmp_path),
                  stats_enabled=False).res_dir is None


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (BOptimizer, lambda: BOptimizerHPOpt(dim_in=3)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    bo = BOptimizerHPOpt(dim_in=3, device="cpu")
    assert isinstance(bo.kernel, kernels.SquaredExpARD) and bo.hp_period == 10
    assert bo.hp_opt is not None and bo.acqui_optimizer.repeats == 64


@pytest.mark.parametrize("kw,exc", [
    (dict(cache_lite=True), ValueError),
    (dict(cache_fast_update="fast"), ValueError),
    (dict(model_type="sparse"), ValueError)])
def test_options_not_ported_raise(kw, exc):
    with pytest.raises(exc, match="queue 1" if exc is NotImplementedError
                       else None):
        BOptimizer(device="cpu", **kw)


_NEW_OPTIONS = {
    "refined": dict(use_query_cache=True, cache_fast_update="refined"),
    "raw": dict(use_query_cache=True, cache_fast_update=True),
    "lite": dict(use_query_cache=True, cache_fast_update="deferred",
                 cache_lite=True, cache_defer_m=1),
    "spgp": dict(model_type="spgp", model_options=dict(m=4), hp_period=1),
    "iterative": dict(model_type="iterative",
                      model_options=dict(block=128, cg_tol=1e-9)),
    "sparse": dict(max_model_points=5),
}


@pytest.mark.parametrize("name", list(_NEW_OPTIONS))
def test_new_option_step_equals_reference(name):
    """One ask -> tell step of each option the port's BOptimizer gained
    (the query cache's "refined", True and lite appends, the spgp and
    iterative families, max_model_points) from the reference's 6 init
    points with its sweep injected (and, for spgp, its pseudo-inputs and
    an SPGPHpOpt(Rprop(3)) after the step): the proposal, its acquisition
    value and predicted mean, then the model's state (and the cache's)
    field by field, f64 to 1e-9 (a bf16 mirror to one bf16 step; the
    iterative GP's CG stops at 1e-9 in both)."""
    kw = dict(_NEW_OPTIONS[name])
    jkw, tkw = dict(kw), dict(kw)
    if name == "lite":
        jkw["cache_query_dtype"] = jnp.bfloat16
        tkw["cache_query_dtype"] = torch.bfloat16
    if name == "spgp":
        from limbo_tpu.models.spgp import SPGPHpOpt as JSPGPHpOpt
        jkw["hp_opt"] = JSPGPHpOpt(optimizer=JRprop(iterations=3))
        tkw["hp_opt"] = tbo_models.SPGPHpOpt(optimizer=Rprop(iterations=3))
    jopt = JRandomRestarts(sub=JRprop(iterations=3), repeats=2,
                           sweep_samples=16)
    jbo = JBOptimizer(acqui_optimizer=jopt, init=JRandomSampling(6),
                      stop=(JMaxIterations(3),), dtype=jnp.float64, **jkw)
    js = jbo.init_state(D, key=KEY)
    xb0 = np.array(js.gp.xb) if name == "spgp" else None
    X0 = [np.asarray(x) for x in js.pending_init]
    for x in X0:
        js = jbo.tell(js, x, quad(x))
    _, k_prop = jax.random.split(js.key)
    sweep = jax.random.uniform(jax.random.split(k_prop, 3)[2], (16, D))
    jx = jbo.ask(js)
    js = jbo.tell(js, jx, quad(jx))

    bo = _small(acqui_optimizer=_FromSweep(
        RandomRestarts(sub=Rprop(iterations=3), repeats=2, sweep_samples=16),
        sweep), init=RandomSampling(6), stop=(MaxIterations(3),), **tkw)
    st = bo.init_state(D, generator=torch.Generator().manual_seed(0))
    if name == "spgp":
        assert st.gp.xb.shape == (4, D)
        st.gp = st.gp.replace(xb=torch.from_numpy(xb0))
    for x in X0:
        st = bo.tell(st, x, quad(x))
    tx = bo.ask(st)
    np.testing.assert_allclose(tx, np.asarray(jx), **TOL)
    np.testing.assert_allclose(st.last_acqui_value, js.last_acqui_value,
                               **TOL)
    np.testing.assert_allclose(st.last_prediction, js.last_prediction, **TOL)
    st = bo.tell(st, tx, quad(tx))
    assert st.gp.n == int(js.gp.n) == (5 if name == "sparse" else 7)
    assert type(st.gp).__name__ == type(js.gp).__name__
    # the posterior's state, field by field (no query program to compile)
    names = {"spgp": ("x", "y", "xb"), "iterative": ("x", "y", "alpha")}
    for f in names.get(name, ("x", "y", "L", "alpha")):
        np.testing.assert_allclose(getattr(st.gp, f).numpy(),
                                   np.asarray(getattr(js.gp, f)), **TOL)
    if name == "spgp":
        np.testing.assert_allclose(st.gp.kernel.params.numpy(),
                                   np.asarray(js.gp.kernel.params), **TOL)
    if kw.get("use_query_cache"):
        assert (st.cache.Kinv is None) == (name == "lite")
        for f in ("Kinv", "K", "Linv", "ay", "u_ones"):
            a, b = getattr(st.cache, f), getattr(js.cache, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        if name == "lite":
            # the bf16 mirror: the same products rounded, one bf16 step
            a = st.cache.Kinv_q.double().numpy()
            b = np.asarray(js.cache.Kinv_q.astype(jnp.float64))
            assert np.all(np.abs(a - b) <= 2.0 ** -7 * np.abs(b) + 1e-12)
    assert st.best_value == js.best_value


def test_loops_not_ported_raise():
    """optimize_batch is ported (tests/test_torch_qei.py holds it): here
    it runs two rounds of q = 2; what stays unported, the optimizers'
    multi-GPU (mesh) paths, raises naming its ROADMAP.md item."""
    from limbo_tpu_torch.opt import Cmaes, Nsga2

    bo = BOptimizer(device="cpu", stop=(tbo.MaxIterations(2),),
                    stats_enabled=False)
    state = bo.optimize_batch(quad, D, q=2, restarts=4, steps=5)
    assert state.gp.n == bo.init.count + 2 * 2 and state.iteration == 2
    for opt in (Cmaes, Nsga2):
        with pytest.raises(NotImplementedError, match="queue 1, item 7"):
            opt(mesh=object())
