"""The port's entry-point scripts on the CPU: ``examples/torch/``,
``tutorials/torch/`` and ``scripts/torch_large_n_bench.py``.

* None imports ``jax`` or the JAX package (an AST scan of every import),
  every example and tutorial has ``main``, and the JAX package's
  tests/test_examples.py, which globs the JAX scripts without recursion,
  collects none of them.
* basic_example and mono_dim run on the CPU at a 3-iteration budget: a
  finite best value (tests/test_examples.py's assertion), samples in
  [0, 1]^d and best_value the largest observation.
* The large-n bench's fit, cache build and one iteration (its acquisition's
  point, appended) at n = 512 on seeded numpy data, against the JAX
  package's gp.fit, QueryCache.build and add_sample_cached on the same f32
  arrays (one jitted program), and the cached posterior at the proposed
  point.  Tolerance: both packages round in f32 in other orders, so each
  array within kappa(K) 2^-22 (twice f32's relative rounding, times the f64
  condition number of the fitted covariance's valid block, ~42 here) of
  the larger of 1 and its largest entry; the bf16 mirror within one bf16
  rounding (2^-8 of the largest entry).
"""

import ast
import math
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limbo_tpu.kernels import SquaredExpARD as JSquaredExpARD
from limbo_tpu.means import DataMean as JDataMean
from limbo_tpu.models import gp as jgp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted([*(ROOT / "examples" / "torch").rglob("*.py"),
                   *(ROOT / "tutorials" / "torch").glob("*.py")])
BENCH = ROOT / "scripts" / "torch_large_n_bench.py"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_scripts_import_only_the_port_and_have_main():
    assert len(EXAMPLES) == 15
    for path in [*EXAMPLES, BENCH]:
        names = _imports(path)
        assert not names & {"jax", "jaxlib", "limbo_tpu"}, (path, names)
        assert "limbo_tpu_torch" in names or path == BENCH, path
    for path in EXAMPLES:
        assert "main" in runpy.run_path(str(path), run_name="_scan"), path
    import test_examples
    assert not any("torch" in p.parts for p in test_examples.SCRIPTS)


@pytest.mark.parametrize("name,dim,kw", [
    ("tutorials/torch/basic_example.py", 1, {}),
    ("examples/torch/mono_dim.py", 2, {"res_base_dir": None})])
def test_example_runs_on_the_cpu(name, dim, kw):
    state = runpy.run_path(str(ROOT / name), run_name="_run")["main"](
        device="cpu", iterations=3, **kw)
    n = state.gp.n
    x = state.gp.x[:n].numpy()
    y = state.gp.y[:n, 0].numpy()
    assert n == 13 and x.shape == (n, dim)
    assert np.isfinite(state.best_value) and (x >= 0).all() and (x <= 1).all()
    assert state.best_value == y.max()


def _jax_model(d, noise, ell):
    """The bench's kernel and mean in the JAX package."""
    kernel = JSquaredExpARD.create(dim=d, noise=noise, dtype=jnp.float32)
    kernel = kernel.replace(log_ell=jnp.full((d,), math.log(ell),
                                             dtype=jnp.float32))
    return kernel, JDataMean.create(dim_out=1, dtype=jnp.float32)


def test_large_n_bench_matches_the_jax_package():
    bench = runpy.run_path(str(BENCH), run_name="_bench")
    n = 512
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(n, bench["D"])).astype(np.float32)
    Y = (np.sin(3.0 * X.sum(axis=1, keepdims=True))
         + bench["Y_NOISE"] * rng.normal(size=(n, 1))).astype(np.float32)
    w = bench["Workload"](n, device="cpu", X=X, Y=Y)
    gp = w.fit()
    cache = w.build(gp)
    N = gp.capacity
    assert N == bench["capacity_for"](n) == 1024
    x = w.acquire(gp, cache)                # the iteration's proposal
    assert x.shape == (bench["D"],) and bool(((x >= 0) & (x <= 1)).all())
    y = w.objective(x)
    mu, var = w.gp_mod.query_cached(gp, cache, x[None, :])
    fit = {k: getattr(gp, k).clone() for k in ("L", "alpha")}
    built = {k: getattr(cache, k).clone()
             for k in ("Kinv", "Linv", "Kinv_q", "ay", "u_ones", "P")}
    gp2, cache2 = w.append(gp, cache, x)    # in place: compared after

    kernel, mean = _jax_model(bench["D"], bench["NOISE"], bench["ELL"])

    @jax.jit                                # one compile for the pipeline
    def reference(X, Y, x, y):
        jg = jgp.fit(kernel, mean, X, Y, capacity=N)
        jc = jgp.QueryCache.build(jg, with_Linv=True, qdtype=jnp.bfloat16,
                                  defer_m=bench["DEFER_M"])
        post = jgp.query_cached(jg, jc, x[None, :])
        return (jg, jc, post) + jgp.add_sample_cached(
            jg, jc, x, y, fast_update="deferred")

    jg, jc, (jmu, jvar), jg2, jc2 = reference(X, Y, x.numpy(), y.numpy())
    Kn = np.asarray(jg.L, np.float64)[:n, :n]
    rel = np.linalg.cond(Kn @ Kn.T) * 2.0 ** -22

    def close(got, want, r=rel):
        got = got.float().numpy()
        want = np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_allclose(
            got, want, rtol=0, atol=r * max(1.0, np.abs(want).max()))

    for k, t in fit.items():
        close(t, getattr(jg, k))
    for k, t in built.items():
        close(t, getattr(jc, k), 2.0 ** -8 if k == "Kinv_q" else rel)
    close(mu, jmu)
    close(var, jvar)
    assert gp2.n == int(jg2.n) == n + 1
    for k in ("x", "y", "L", "alpha"):
        close(getattr(gp2, k), getattr(jg2, k))
    for k in ("Linv", "P", "ay", "u_ones"):
        close(getattr(cache2, k), getattr(jc2, k))
