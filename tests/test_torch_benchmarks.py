"""The port's benchmark suites (limbo_tpu_torch.benchmarks) against the JAX
package's: the BO and regression test functions, the f64 oracle, the
regression runner's two-phase hyperparameter learning, and the harnesses'
plumbing (tiny budgets; the full protocols run on the card through
scripts/torch_bo_suite.py and scripts/torch_regression_suite.py).

Inputs are drawn with numpy from a seed; f64 runs with x64 on
(tests/conftest.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limbo_tpu.benchmarks import bo_suite as jbo
from limbo_tpu.benchmarks import functions as jfun
from limbo_tpu.benchmarks import oracle as joracle
from limbo_tpu.benchmarks import regression_functions as jreg
from limbo_tpu.benchmarks import regression_suite as jrs
from limbo_tpu_torch.acqui import UCB
from limbo_tpu_torch.benchmarks import bo_suite, oracle, plots
from limbo_tpu_torch.benchmarks import functions as tfun
from limbo_tpu_torch.benchmarks import regression_functions as treg
from limbo_tpu_torch.benchmarks import regression_suite as trs
from limbo_tpu_torch.models.hp_opt import KernelLFOpt
from limbo_tpu_torch.opt import Cmaes, DirectL, RandomRestarts, Rprop

torch.set_num_threads(1)

CPU = dict(device="cpu")
# the function tables: f64 to 1e-12 relative (the same formulas, summed in
# the same order); f32 to 1e-6 of the largest value of the batch, since a
# value near zero is a difference of terms of that size, each rounded in
# f32 (and jnp's and torch's f32 sin / cos / exp differ in the last bit)
F64_RTOL, F32_TOL = 1e-12, 1e-6


def _check_table(want, got, dtype):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=F32_TOL,
                                   atol=F32_TOL * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("i", range(8),
                         ids=[f.name for f in jfun.ALL_FUNCTIONS])
def test_bo_function(i, dtype):
    """Each BO test function at 256 points; its solutions, f_opt and
    accuracy equal to the reference's."""
    jf, tf = jfun.ALL_FUNCTIONS[i], tfun.ALL_FUNCTIONS[i]
    assert (tf.name, tf.dim_in) == (jf.name, jf.dim_in)
    np.testing.assert_array_equal(tf.solutions, jf.solutions)
    X = np.random.default_rng(i).uniform(size=(256, jf.dim_in))
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = jax.vmap(jf.fn)(jnp.asarray(X, jd))
    _check_table(want, tf.fn(torch.tensor(X, dtype=dtype)), dtype)
    # the captured objective: (d,) -> (1,), maximized, its tables built once
    f = tf.as_max_objective("cpu", dtype)
    np.testing.assert_array_equal(f(torch.tensor(X[0], dtype=dtype)).numpy(),
                                  -tf.fn(torch.tensor(X[:1], dtype=dtype)))
    if dtype == torch.float64:
        assert tf.f_opt == jf.f_opt
        assert tf.accuracy(0.25) == jf.accuracy(0.25)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("i", range(8),
                         ids=[f.name for f in jreg.ALL_REGRESSION])
def test_regression_function(i, dtype):
    """Each regression function at 256 points of its native domain, at
    every benchmark dim; its bounds and the unit-cube scaling."""
    jf, tf = jreg.ALL_REGRESSION[i], treg.ALL_REGRESSION[i]
    assert (tf.name, tuple(tf.dims)) == (jf.name, tuple(jf.dims))
    np.testing.assert_array_equal(tf.bounds, jf.bounds)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    rng = np.random.default_rng(100 + i)
    for d in jf.dims:
        U = rng.uniform(size=(256, d))
        b = jf.bounds_for_dim(d)
        np.testing.assert_array_equal(tf.bounds_for_dim(d), b)
        X = b[:, 0] + U * (b[:, 1] - b[:, 0])
        want = jax.vmap(jf.fn)(jnp.asarray(X, jd))
        _check_table(want, tf.fn(torch.tensor(X, dtype=dtype)), dtype)
        _check_table(jf.scale(jnp.asarray(U, jd)),
                     tf.scale(torch.tensor(U, dtype=dtype)), dtype)


@pytest.mark.parametrize("optimize_noise", [True, False],
                         ids=["noise", "fixed"])
def test_oracle_matches_reference(optimize_noise):
    """The port's copy of the f64 NumPy oracle: the same fit, the same MSE."""
    rng = np.random.default_rng(7)
    X = rng.uniform(size=(40, 2))
    Y = np.sin(4.0 * X.sum(axis=1, keepdims=True)) \
        + 0.05 * rng.standard_normal((40, 1))
    Xq = rng.uniform(size=(64, 2))
    Yq = np.sin(4.0 * Xq.sum(axis=1, keepdims=True))
    a = joracle.fit(X, Y, optimize_noise=optimize_noise)
    b = oracle.fit(X, Y, optimize_noise=optimize_noise)
    for f in ("log_ell", "log_sf", "log_noise", "L", "alpha"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=1e-12,
                                   atol=1e-12)
    ma = joracle.fit_and_eval(X, Y, Xq, Yq, optimize_noise)[0]
    mb = oracle.fit_and_eval(X, Y, Xq, Yq, optimize_noise)[0]
    np.testing.assert_allclose(mb, ma, rtol=1e-12)


def test_regression_runner_matches_reference():
    """GramacyLee d1 at n = 60, f64, precise, 2 hp restarts: the port's
    runner on the reference's data (its make_data) and the reference's
    restart perturbations, through both hp-opt phases (with the noise
    learned, the tiny-noise second basin and its exact-LML choice) and the
    final f64 refit: the learned log-parameters and the MSE to 1e-6
    relative."""
    jspec, tspec = jrs.DEFAULT_MODELS[0], trs.DEFAULT_MODELS[0]
    assert (tspec.name, tspec.optimize_noise) == (jspec.name,
                                                  jspec.optimize_noise)
    n, R = 60, 2
    make_data, fit_fn, query_fn = jrs._make_runner(
        jreg.GRAMACY_LEE, 1, n, jspec, dtype=jnp.float64, precise=True,
        hp_restarts=R)
    kd, k1 = jax.random.split(jax.random.PRNGKey(13))
    U, Y, Uq, Yq = make_data(kd)
    gp = fit_fn(U, Y, k1)
    mse = float(query_fn(gp, Uq, Yq)[0])
    # the reference's phase-1 perturbations (_multi_start's first key)
    P = gp.kernel.params.shape[0]
    pert = np.asarray(jax.random.uniform(jax.random.split(k1, R + 1)[0],
                                         (R, P), jnp.float64, -3.0, 3.0))
    _, tfit, tquery = trs._make_runner(
        treg.GRAMACY_LEE, 1, n, tspec, dtype=torch.float64, precise=True,
        hp_restarts=R, **CPU)
    t = lambda a: torch.tensor(np.asarray(a))
    tgp = tfit(t(U), t(Y), torch.Generator().manual_seed(0),
               pert=torch.tensor(pert))
    tmse = float(tquery(tgp, t(Uq), t(Yq))[0])
    np.testing.assert_allclose(tgp.kernel.params.numpy(),
                               np.asarray(gp.kernel.params), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(tmse, mse, rtol=1e-6)
    assert tgp.x.dtype == torch.float64 and mse < 1.0


def _config(obj):
    """A dataclass's class name and fields, recursively, for comparing a
    reference configuration with the port's."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, {f.name: _config(getattr(obj, f.name))
                                     for f in dataclasses.fields(obj)})
    return obj


def test_default_variants_match_reference():
    """All 7 variants, field by field (acquisitions, acquisition optimizers
    and their sub-optimizers, hp-opt flags and period)."""
    ref, port = jbo.default_variants(), bo_suite.default_variants()
    assert [v.name for v in port] == [v.name for v in ref]
    for a, b in zip(ref, port):
        cb = _config(b)
        ca = _config(a)
        # the reference's CMA-ES carries its mesh fields, None there and
        # here (the port raises on a mesh)
        assert cb == ca, (a.name, ca, cb)


def _tiny(name, opt, hp=False):
    return bo_suite.Variant(name, UCB(0.5), opt, hp_opt=hp, hp_period=2)


@pytest.mark.parametrize("variant", [
    _tiny("restarts", RandomRestarts(sub=Rprop(iterations=5), repeats=4,
                                     sweep_samples=32)),
    _tiny("cmaes", Cmaes(iterations=4, pop_size=8)),
    _tiny("direct", DirectL(rounds=4, splits_per_round=4)),
    _tiny("hpopt", RandomRestarts(sub=Rprop(iterations=5), repeats=4,
                                  sweep_samples=32), hp=True),
], ids=lambda v: v.name)
def test_bo_suite_smoke(variant, tmp_path, monkeypatch):
    """A tiny run of each optimizer kind (and of the hp-opt cadence, its
    strategy cut from 5 x Rprop(300) to 2 x Rprop(5) for time) through
    run_suite and optimize_jit: the .dat row, a finite accuracy, the
    summary."""
    calls = []
    cut = KernelLFOpt(optimizer=Rprop(iterations=5), restarts=2,
                      epsilon=0.5, objective_jitter="auto")

    def strategy():
        calls.append(1)
        return cut

    monkeypatch.setattr(bo_suite, "hp_strategy", strategy)
    summary = bo_suite.run_suite([variant], [tfun.BRANIN], nb_reps=1,
                                 n_init=4, n_iters=4, out_dir=str(tmp_path),
                                 dtype=torch.float64, verbose=False, **CPU)
    key = f"{variant.name}/BraninNormalized"
    assert np.isfinite(summary[key]["accuracy"])
    rows = np.loadtxt(tmp_path / variant.name / "BraninNormalized.dat",
                      ndmin=2)
    assert rows.shape == (1, 2) and rows[0, 0] == pytest.approx(
        summary[key]["accuracy"], abs=1e-6)
    assert summary[key]["compile_ms"] == 0.0       # nothing captured here
    assert len(calls) == int(variant.hp_opt)


def test_bo_suite_resume_and_merge(tmp_path):
    """A partial .dat resumes at the missing replicate (no duplicate rows),
    a complete one is not rerun, and summary.json merges entries of other
    runs instead of replacing them."""
    v = _tiny("resume", RandomRestarts(sub=Rprop(iterations=5), repeats=4,
                                       sweep_samples=32))
    (tmp_path / "summary.json").write_text('{"other/Sphere": {"accuracy": 1}}')
    vdir = tmp_path / "resume"
    vdir.mkdir()
    (vdir / "Sphere.dat").write_text("0.123456 42.000\n")
    (vdir / "BraninNormalized.dat").write_text("0.5 1.0\n0.7 2.0\n")
    summary = bo_suite.run_suite([v], [tfun.SPHERE, tfun.BRANIN], nb_reps=2,
                                 n_init=4, n_iters=3, out_dir=str(tmp_path),
                                 dtype=torch.float64, verbose=False, **CPU)
    rows = np.loadtxt(vdir / "Sphere.dat", ndmin=2)
    assert rows.shape[0] == 2 and rows[0, 0] == 0.123456
    assert np.loadtxt(vdir / "BraninNormalized.dat", ndmin=2).shape[0] == 2
    assert summary["resume/BraninNormalized"]["accuracy"] == 0.6
    assert summary["other/Sphere"] == {"accuracy": 1}
    # the replicate's seed is 1000 rep + 7: rep 1 alone repeats its row
    acc = bo_suite.run_one(v, tfun.SPHERE, 4, 3, 1007, torch.float64, **CPU)
    assert abs(acc[0] - rows[1, 0]) < 1e-6


def test_regression_suite_smoke(tmp_path, monkeypatch):
    """run_regression_suite (f64, not precise and 2 hp restarts, for time)
    with the oracle sidecar (2 replicates, 1 oracle replicate), then a
    resume that adds the second oracle replicate and runs nothing else."""
    runner = trs._make_runner
    monkeypatch.setattr(trs, "_make_runner", lambda *a, **k: runner(
        *a, **k, hp_restarts=2))
    fn = dataclasses.replace(treg.GRAMACY_LEE, dims=(1,))
    kw = dict(functions=[fn], models=[trs.ModelSpec("smoke", False)],
              points=(30,), nb_reps=2, out_dir=str(tmp_path),
              dtype=torch.float64, verbose=False, precise=False, **CPU)
    summary = trs.run_regression_suite(oracle_reps=1, **kw)
    tag = "GramacyLee_d1_n30_smoke"
    assert summary[tag]["mse"] < 1.0 and "oracle_mse" in summary[tag]
    row = np.loadtxt(tmp_path / f"{tag}.dat", ndmin=2)
    summary = trs.run_regression_suite(oracle_reps=2, **kw)
    np.testing.assert_array_equal(np.loadtxt(tmp_path / f"{tag}.dat",
                                             ndmin=2), row)
    assert np.loadtxt(tmp_path / f"{tag}.oracle.dat", ndmin=2).shape == (2, 3)
    assert summary[tag]["vs_oracle_learn"] > 0


def test_plots_read_dat_trees(tmp_path):
    """The port's copy of the plot helpers reads the suites' .dat layouts."""
    vdir = tmp_path / "bo" / "variantA"
    vdir.mkdir(parents=True)
    (vdir / "Sphere.dat").write_text("0.01 120.0\n0.02 130.0\n")
    res = plots.load_bo_results(str(tmp_path / "bo"))
    assert res["variantA"]["Sphere"].shape == (2, 2)
    assert plots.plot_bo_benchmarks(str(tmp_path / "bo")).endswith(".png")
    rdir = tmp_path / "reg"
    rdir.mkdir()
    (rdir / "F_d1_n50_m.dat").write_text("0.01 12.0 1.5\n0.02 13.0 1.6\n")
    assert plots.plot_regression_benchmarks(str(rdir)).endswith(".png")


def test_suite_scripts_import_no_jax():
    """The suite scripts stand alone, as the package does
    (tests/test_torch_rules.py)."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "scripts").glob("torch_*.py"))
    assert {"torch_bo_suite.py", "torch_regression_suite.py"} <= {
        f.name for f in files}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for m in names:
                assert m.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "limbo_tpu"), (f.name, m)


def test_suites_default_to_the_card(monkeypatch, tmp_path):
    """Without a card, the suites' entry points called without
    device='cpu' raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bo_suite.run_one(bo_suite.default_variants()[0], tfun.SPHERE, 2, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trs.run_regression_suite(functions=[treg.STEP], points=(5,),
                                 nb_reps=1, out_dir=str(tmp_path))
