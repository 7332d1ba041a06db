"""Persistence and tooling of the port against the JAX package's:
serialization (both archives, recompute, and archives carried across the
two packages both ways), checkpoint / resume, the config tree, the
experiment scaffold and launcher, the CLI, the ROS adapter, the profiling
helpers and the scikit-learn baseline.

GPs are fitted from seeded NumPy data in f64 on the CPU (tests/conftest.py
enables x64 for the reference); a loaded GP's queries agree with the saved
one's to 1e-12, and what is loaded in the same package holds the saved
bits.
"""

import ast
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limbo_tpu.kernels as jk
import limbo_tpu.means as jm
from limbo_tpu.config import Config as JConfig
from limbo_tpu.models import gp as jgp
from limbo_tpu.utils import serialize as jser
from limbo_tpu_torch import kernels, means
from limbo_tpu_torch.bo import BOptimizer, MaxIterations, RandomSampling
from limbo_tpu_torch.bo.checkpoint import load_state, save_state
from limbo_tpu_torch.bo.optimizer import EvaluationError
from limbo_tpu_torch.config import Config
from limbo_tpu_torch.experiment import (create_exp, generate_job_scripts,
                                        load_conf, run_local)
from limbo_tpu_torch.integrations import RosObjective, make_ros_objective
from limbo_tpu_torch.models import gp as tgp
from limbo_tpu_torch.opt import RandomSweep
from limbo_tpu_torch.utils import serialize as tser

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
_jfit = jax.jit(jgp.fit, static_argnames=("capacity",))
_jquery = jax.jit(jgp.query)
_FIELDS = ("x", "y", "L", "alpha")


def _data(rng, n=20):
    X = rng.uniform(size=(n, 2))
    return X, np.sin(X.sum(1, keepdims=True)) + 0.1 * rng.normal(size=(n, 1))


def _port_se(capacity):
    return tgp.empty(kernels.SquaredExpARD.create(dim=2, **F64),
                     means.DataMean.create(**F64), 2, capacity=capacity,
                     **F64)


def _assert_same_queries(a, b):
    """a, b: (mu, var) pairs of tensors or arrays, equal to 1e-12."""
    for u, v in zip(a, b):
        np.testing.assert_allclose(np.asarray(u), np.asarray(v), rtol=0,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# serialization (tests/test_serialize.py, test_serialize.cpp:181-201)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("archive", ["BinaryArchive", "TextArchive"])
def test_roundtrip(tmp_path, archive):
    rng = np.random.default_rng(42)
    X, Y = _data(rng)
    gp = tgp.fit(kernels.SquaredExpARD.create(dim=2, **F64),
                 means.DataMean.create(**F64), torch.from_numpy(X),
                 torch.from_numpy(Y), **F64)
    d = str(tmp_path / "model")
    tser.save_gp(gp, d, archive=getattr(tser, archive))
    gp2 = tser.load_gp(_port_se(gp.capacity), d)
    for f in _FIELDS:
        assert torch.equal(getattr(gp2, f), getattr(gp, f)), f
    assert gp2.n == gp.n and int(gp2.n_dev) == gp.n
    assert torch.equal(gp2.mean.value, gp.mean.value)
    Xq = torch.from_numpy(rng.uniform(size=(9, 2)))
    _assert_same_queries(tgp.query(gp, Xq), tgp.query(gp2, Xq))
    names = sorted(os.listdir(d))
    suffix = getattr(tser, archive).suffix
    assert names == [f"leaf_{i:03d}{suffix}"
                     for i in range(len(names) - 1)] + ["meta.json"]


def test_load_with_recompute(tmp_path):
    rng = np.random.default_rng(42)
    X = rng.uniform(size=(15, 2))
    Y = rng.normal(size=(15, 1))
    gp = tgp.fit(kernels.SquaredExpARD.create(dim=2, **F64),
                 means.DataMean.create(**F64), torch.from_numpy(X),
                 torch.from_numpy(Y), **F64)
    d = str(tmp_path / "model")
    tser.save_gp(gp, d)
    # a stored factor that recompute must replace
    meta = json.load(open(os.path.join(d, "meta.json")))
    leaf = {e["key"]: e["file"] for e in meta["leaves"]}[".L"]
    np.save(os.path.join(d, leaf + ".npy"), np.eye(gp.capacity))
    gp2 = tser.load_gp(_port_se(gp.capacity), d, recompute=True)
    np.testing.assert_allclose(gp2.L.numpy(), gp.L.numpy(), atol=1e-10)
    np.testing.assert_allclose(gp2.alpha.numpy(), gp.alpha.numpy(),
                               atol=1e-10)
    with pytest.raises(KeyError):
        tser.load_gp(tgp.empty(kernels.MaternFiveHalves.create(**F64),
                               means.DataMean.create(**F64), 2,
                               capacity=gp.capacity, **F64), d)


def _jax_nested():
    return (jk.SquaredExpARD.create(dim=2, rank=1, dtype=jnp.float64),
            jm.FunctionARD.create(jm.ConstantMean.create(
                2.0, dtype=jnp.float64)))


def _port_nested():
    return (kernels.SquaredExpARD.create(dim=2, rank=1, **F64),
            means.FunctionARD.create(means.ConstantMean.create(2.0, **F64),
                                     device="cpu"))


@pytest.mark.parametrize("archive", ["BinaryArchive", "TextArchive"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_load(tmp_path, archive, direction):
    """An archive written by either package loads into the other (a
    low-rank SquaredExpARD and a FunctionARD mean, whose nested module
    gives a nested key): the same files and meta.json, and queries equal
    to 1e-12."""
    rng = np.random.default_rng(7)
    X, Y = _data(rng)
    Xq = rng.uniform(size=(9, 2))
    jg = _jfit(*_jax_nested(), jnp.asarray(X), jnp.asarray(Y), capacity=64)
    tg = tgp.fit(*_port_nested(), torch.from_numpy(X), torch.from_numpy(Y),
                 **F64)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jser.save_gp(jg, jd, archive=getattr(jser, archive))
    tser.save_gp(tg, td, archive=getattr(tser, archive))
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    jmeta, tmeta = (json.load(open(os.path.join(p, "meta.json")))
                    for p in (jd, td))
    assert jmeta == tmeta
    if direction == "jax_to_port":
        loaded = tser.load_gp(tgp.empty(*_port_nested(), 2,
                                        capacity=jg.capacity, **F64), jd)
        got = tgp.query(loaded, torch.from_numpy(Xq))
        want = _jquery(jg, jnp.asarray(Xq))
    else:
        loaded = jser.load_gp(jgp.empty(*_jax_nested(), dim_in=2,
                                        capacity=tg.capacity,
                                        dtype=jnp.float64), td)
        got = _jquery(loaded, jnp.asarray(Xq))
        want = tgp.query(tg, torch.from_numpy(Xq))
    _assert_same_queries(got, want)


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def quad(x):
    return np.array([-np.sum((np.asarray(x) - 0.3) ** 2)])


def test_bo_checkpoint_resume(tmp_path):
    """tests/test_serialize.py:52 on the port: save a run mid-flight,
    reload it into a template and continue with reset=False."""
    bo = BOptimizer(init=RandomSampling(4), stop=(MaxIterations(5),),
                    acqui_optimizer=RandomSweep(samples=64),
                    stats_enabled=False, dtype=torch.float64, device="cpu")
    state = bo.optimize(quad, dim_in=2,
                        generator=torch.Generator().manual_seed(0))
    n_before = state.gp.n
    save_state(state, str(tmp_path / "ckpt"))
    template = tgp.empty(bo._make_gp(2, 1, state.gp.capacity).kernel,
                         means.DataMean.create(**F64), 2,
                         capacity=state.gp.capacity, **F64)
    restored = load_state(template, str(tmp_path / "ckpt"))
    assert restored.gp.n == n_before and restored.total_iterations == 5
    assert torch.equal(restored.generator.get_state(),
                       state.generator.get_state())
    assert os.path.exists(tmp_path / "ckpt" / "model" / "meta.json")
    state2 = bo.optimize(quad, dim_in=2, reset=False, state=restored,
                         generator=restored.generator)
    assert state2.gp.n == n_before + 5
    assert state2.total_iterations == 10


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """BOptimizer at its defaults (f32), 15 iterations, a checkpoint, a
    load into a fresh template and 15 more propose the 30 points of one
    30-iteration run from the same seed, bit for bit (the reference's
    resume recomputes nothing either: limbo_tpu/bo/optimizer.py:360-389)."""
    def f(x):
        x = np.asarray(x, dtype=np.float64)
        return np.array([-np.sum((x - 0.3) ** 2) + 0.2 * np.sin(5 * x[0])])

    bo = BOptimizer(stop=(MaxIterations(15),), device="cpu")
    state = bo.optimize(f, 3, generator=torch.Generator().manual_seed(1))
    save_state(state, str(tmp_path / "ckpt"))
    template = bo._make_gp(3, 1, state.gp.capacity)
    restored = load_state(template, str(tmp_path / "ckpt"))
    resumed = bo.optimize(f, 3, reset=False, state=restored,
                          generator=restored.generator)
    whole = BOptimizer(stop=(MaxIterations(30),), device="cpu").optimize(
        f, 3, generator=torch.Generator().manual_seed(1))
    assert resumed.total_iterations == whole.total_iterations == 30
    assert resumed.gp.n == whole.gp.n == 40
    for name in _FIELDS:
        assert torch.equal(getattr(resumed.gp, name),
                           getattr(whole.gp, name)), name


# ---------------------------------------------------------------------------
# config (tests/test_config.py)
# ---------------------------------------------------------------------------

def _cfg_to_dict():
    assert Config().to_dict() == JConfig().to_dict()
    assert len(dataclasses.fields(Config)) == 27


def _cfg_defaults():
    cfg = Config()
    assert cfg.kernel.noise == 0.01 and cfg.kernel.optimize_noise is False
    assert cfg.acqui_ucb.alpha == 0.5 and cfg.acqui_gpucb.delta == 0.1
    assert cfg.acqui_ei.jitter == 0.0 and cfg.opt_rprop.iterations == 300
    assert cfg.stop_maxiterations.iterations == 190
    assert cfg.bayes_opt_boptimizer.hp_period == -1
    assert cfg.init_randomsampling.samples == 10


def _cfg_override():
    cfg = Config()
    c2 = cfg.override("acqui_ucb.alpha", 2.0)
    assert c2.acqui_ucb.alpha == 2.0
    assert c2.override("acqui_ucb.alpha", 3.0).acqui_ucb.alpha == 3.0
    assert cfg.acqui_ucb.alpha == 0.5


def _cfg_typed():
    cfg = Config().override("opt_rprop.iterations", "100")
    assert cfg.opt_rprop.iterations == 100
    assert isinstance(cfg.opt_rprop.iterations, int)
    with pytest.raises(AttributeError):
        Config().override("opt_rprop.not_a_param", 1)
    with pytest.raises(AttributeError):
        Config().override("no_such_namespace.x", 1)
    with pytest.raises(KeyError):
        Config().override("flat_name_no_dot", 1)


def _cfg_from_cli():
    argv = ["--acqui_ucb.alpha=0.125", "--stop_maxiterations.iterations=40",
            "--kernel.optimize_noise=true", "positional-ignored"]
    cfg = Config.from_cli(argv)
    assert cfg.acqui_ucb.alpha == 0.125
    assert cfg.stop_maxiterations.iterations == 40
    assert cfg.kernel.optimize_noise is True
    assert cfg.to_dict() == JConfig.from_cli(argv).to_dict()


def _cfg_pretty():
    text = Config().pretty()
    assert text == JConfig().pretty()
    assert "kernel.noise = 0.01" in text
    n_leaves = sum(len(dataclasses.fields(getattr(Config(), f.name)))
                   for f in dataclasses.fields(Config))
    assert len(text.splitlines()) == n_leaves


def _cfg_diff():
    cfg = Config().override_many({"acqui_ucb.alpha": 0.125,
                                  "opt_cmaes.restarts": 3})
    assert cfg.diff() == {"acqui_ucb.alpha": 0.125, "opt_cmaes.restarts": 3}
    assert Config().diff() == {}


@pytest.mark.parametrize("case", [_cfg_to_dict, _cfg_defaults, _cfg_override,
                                  _cfg_typed, _cfg_from_cli, _cfg_pretty,
                                  _cfg_diff],
                         ids=lambda c: c.__name__[5:])
def test_config(case):
    case()


# ---------------------------------------------------------------------------
# experiment scaffold, launcher and CLI (tests/test_experiment.py)
# ---------------------------------------------------------------------------

def _imports(src):
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_create_exp(tmp_path):
    d = create_exp("myexp", base_dir=str(tmp_path), dim_in=3, iterations=7,
                   samples=4)
    conf = json.load(open(os.path.join(d, "conf.json")))
    assert conf["exps"] == ["myexp"] and conf["bin_dir"] == d
    src = open(os.path.join(d, "myexp.py")).read()
    assert "DIM_IN = 3" in src and "MaxIterations(7)" in src
    assert "DEVICE = 'cuda'" in src
    mods = {m.split(".")[0] for m in _imports(src)}
    assert {"torch", "limbo_tpu_torch"} <= mods
    assert not mods & {"jax", "jaxlib", "flax", "limbo_tpu"}
    d = create_exp("cpuexp", base_dir=str(tmp_path), device="cpu")
    assert "DEVICE = 'cpu'" in open(os.path.join(d, "cpuexp.py")).read()


def test_run_local_replicates(tmp_path):
    """A generated experiment on the CPU, two replicates at once: exit
    codes [0, 0], and each replicate's stats files with finite rows."""
    d = create_exp("quick", base_dir=str(tmp_path / "exp"), samples=4,
                   iterations=3, device="cpu")
    conf = load_conf(os.path.join(d, "conf.json"))
    conf.update(nb_runs=2, res_dir=str(tmp_path / "results"))
    assert run_local(conf, parallel=2) == [0, 0]
    res = tmp_path / "results"
    logs = sorted(p.name for p in res.iterdir() if p.suffix == ".log")
    assert logs == ["quick_0.log", "quick_1.log"]
    runs = [p for p in res.iterdir() if p.is_dir()]
    assert len(runs) == 2
    for run in runs:
        for name in ("samples", "observations", "best_observations",
                     "best_aggregated_observations"):
            rows = np.loadtxt(run / f"{name}.dat", ndmin=2)
            assert rows.shape[0] == 3 and np.isfinite(rows).all()


def test_generate_job_scripts(tmp_path):
    d = create_exp("jobexp", base_dir=str(tmp_path / "exp"))
    conf = load_conf(os.path.join(d, "conf.json"))
    conf.update(nb_runs=3, res_dir=str(tmp_path / "jobs"), bin_dir=d)
    paths = generate_job_scripts(conf)
    assert len(paths) == 3
    body = open(paths[0]).read()
    assert "SBATCH" in body and "jobexp" in body
    assert "jax" not in body.lower() and "XLA" not in body
    assert os.access(paths[0], os.X_OK)


def test_cli_params_and_bad_override(capsys):
    from limbo_tpu_torch.cli import main

    main(["params", "--acqui_ucb.alpha=0.9"])
    assert "acqui_ucb.alpha = 0.9" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        main(["params", "--acqui_ucb.no_such=1"])
    assert e.value.code == 2


def test_cli_create_gen_jobs_and_benches(tmp_path, monkeypatch, capsys):
    """create (with --device), gen-jobs, and bench-bo / bench-regression
    dispatched to the port's suites (monkeypatched here)."""
    from limbo_tpu_torch.benchmarks import bo_suite, regression_suite
    from limbo_tpu_torch.cli import main

    main(["create", "--name", "c", "--base-dir", str(tmp_path), "--dim_in",
          "6", "--samples", "5", "--iterations", "2", "--device", "cpu"])
    src = open(tmp_path / "c" / "c.py").read()
    assert "DIM_IN = 6" in src and "DEVICE = 'cpu'" in src
    conf = load_conf(str(tmp_path / "c" / "conf.json"))
    conf["res_dir"] = str(tmp_path / "jobs")
    json.dump(conf, open(tmp_path / "conf2.json", "w"))
    main(["gen-jobs", str(tmp_path / "conf2.json")])
    assert len(os.listdir(tmp_path / "jobs")) == 10
    calls = []
    monkeypatch.setattr(bo_suite, "run_suite",
                        lambda **kw: calls.append(("bo", kw)))
    monkeypatch.setattr(regression_suite, "run_regression_suite",
                        lambda **kw: calls.append(("reg", kw)))
    main(["bench-bo", "--reps", "2", "--iters", "3", "--out", "o1"])
    main(["bench-regression", "--reps", "1", "--device", "cpu"])
    assert calls == [
        ("bo", dict(nb_reps=2, n_iters=3, out_dir="o1", device="cuda")),
        ("reg", dict(nb_reps=1, out_dir="regression_results_torch",
                     device="cpu"))]


# ---------------------------------------------------------------------------
# ROS adapter (tests/test_integrations.py), with a fake transport
# ---------------------------------------------------------------------------

class FakeResponse:
    def __init__(self, rewards):
        self.rewards = rewards


def test_ros_marshalling_roundtrip():
    seen = []

    def transport(req):
        seen.append(req)
        assert isinstance(req, list) and all(isinstance(v, float)
                                             for v in req)
        return FakeResponse([sum(req)])

    f = make_ros_objective(transport, dim_out=1)
    y = f(np.asarray([0.25, 0.75]))
    assert y.shape == (1,) and y.dtype == np.float32
    np.testing.assert_allclose(float(y[0]), 1.0, atol=1e-6)
    assert float(f(torch.tensor([0.5, 0.25]))[0]) == 0.75
    assert seen == [[0.25, 0.75], [0.5, 0.25]]


def test_ros_scalar_and_sequence_responses():
    assert float(make_ros_objective(lambda r: 2.5)(np.zeros(2))[0]) == 2.5
    y = make_ros_objective(lambda r: (1.0, 2.0), dim_out=2)(np.zeros(2))
    np.testing.assert_allclose(y, [1.0, 2.0])


def test_ros_invalid_responses_raise_evaluation_error():
    with pytest.raises(EvaluationError):
        make_ros_objective(lambda r: float("nan"))(np.zeros(2))
    with pytest.raises(EvaluationError):
        make_ros_objective(lambda r: [1.0, 2.0], dim_out=1)(np.zeros(2))
    with pytest.raises(EvaluationError):
        make_ros_objective(lambda r: None)(np.zeros(2))


def test_ros_transport_retry_then_success():
    calls = {"n": 0}

    def flaky(req):
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("service restarting")
        return [0.5]

    naps = []
    f = RosObjective(flaky, dim_out=1, retries=3, retry_wait_s=0.01,
                     sleeper=naps.append)
    assert float(f(np.zeros(1))[0]) == 0.5
    assert calls["n"] == 3 and len(naps) == 2

    def down(req):
        raise ConnectionError("no service")

    with pytest.raises(EvaluationError, match="after 2 attempts"):
        RosObjective(down, retries=1, sleeper=naps.append)(np.zeros(1))


def test_ros_bo_loop_through_the_adapter():
    """The port's BOptimizer drives a fake robot service and finds the
    optimum of -(x - 0.6)^2."""
    def robot_service(req):
        x = np.asarray(req)
        return FakeResponse([float(-np.sum((x - 0.6) ** 2))])

    f = make_ros_objective(robot_service, dim_out=1)
    bo = BOptimizer(init=RandomSampling(8), stop=(MaxIterations(25),),
                    stats_enabled=False, device="cpu")
    state = bo.optimize(f, dim_in=2, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(state.best_sample, [0.6, 0.6], atol=0.15)
    assert f.n_calls == 33


# ---------------------------------------------------------------------------
# profiling and the scikit-learn baseline
# ---------------------------------------------------------------------------

def test_profiling_on_the_cpu(tmp_path):
    from limbo_tpu_torch.utils.profiling import PhaseTimer, device_sync, trace

    device_sync(torch.ones(2))                    # nothing to wait for
    device_sync({"a": [torch.ones(1)]})
    timer = PhaseTimer()
    for _ in range(2):
        with timer("fit", sync=torch.zeros(3)):
            torch.ones(4).sum()
    assert timer.counts["fit"] == 2 and "fit" in timer.summary()
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).cumsum(0)
    assert prof is not None
    events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def test_sklearn_baseline_is_the_reference_protocol():
    """The port's copy is the reference's function, statement for
    statement, and imports scikit-learn only inside it (the card's
    machine has none), so importing the module needs no scikit-learn."""
    import limbo_tpu.benchmarks.sklearn_baseline as jsk
    import limbo_tpu_torch.benchmarks.sklearn_baseline as tsk

    def body(mod):
        tree = ast.parse(open(mod.__file__).read())
        fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef))
        fn.body = fn.body[1:]                    # past the docstring
        return tree, ast.dump(fn)

    (ttree, tfn), (_, jfn) = body(tsk), body(jsk)
    assert tfn == jfn
    top = {m.split(".")[0] for m in _imports(ast.unparse(ast.Module(
        body=[n for n in ttree.body if not isinstance(n, ast.FunctionDef)],
        type_ignores=[])))}
    assert "sklearn" not in top and top <= {"__future__", "time", "typing",
                                            "numpy"}
