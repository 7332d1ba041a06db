"""The fast-matmul mode (``limbo_tpu_torch/utils/precision.py``) on the CPU.

* The import reads ``LIMBO_TPU_FAST_MATMUL`` as the reference does (any
  non-empty value turns the mode on), in a fresh process.
* Classification: torch's product functions and methods (``@``, ``mm``,
  ``bmm``, ``mv``, ``dot``, ``einsum``, ``addmm``), wrapped, record at
  every product the package issues the package function that issued it
  and the cuBLAS precision in force, over a small fit, cache builds on both
  routes, deferred appends past a flush, an immediate ("refined") append
  and a plain one, cached and uncached queries, an LML and its gradient, the
  blocked factor and its pullback, every kernel wrapper's CPU route and the
  sharded factor at one gloo rank (n <= 512).  With the mode on, each
  record must match the module's table (``exact`` rows "ieee", ``tf32``
  rows "tf32"), whose exact rows are the reference's ``HIGHEST`` pins; with
  it off, every product is "ieee".
* The CPU has no TF32: with the mode on, bench.py's step at n = 256
  (``bench_torch.make_step``: the fit, the cache with its bf16 mirror and
  one deferred append) computes every bit it computes with the mode off.
  The step itself is held to the reference's assertions and the host-int
  path in tests/test_torch_graph.py, and the same fit, cache and append
  to the JAX package's in tests/test_torch_examples.py (the large-n bench).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench_torch
from limbo_tpu_torch import kernels, means
from limbo_tpu_torch.models import gp as tgp
from limbo_tpu_torch.ops import chol, gram_pallas, mirror, trimv
from limbo_tpu_torch.utils import precision

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "limbo_tpu_torch"
PRODUCTS = {torch: ("matmul", "mm", "bmm", "mv", "dot", "einsum", "addmm",
                    "baddbmm"),
            torch.Tensor: ("__matmul__", "__rmatmul__", "matmul", "mm", "bmm",
                           "mv", "dot", "addmm", "addmm_")}


def _table():
    """{(file, function): "exact" | "tf32"} from the module docstring."""
    lines = precision.__doc__.splitlines()
    rules = [i for i, ln in enumerate(lines) if ln.strip().startswith("----")]
    rows = {}
    for ln in lines[rules[0] + 1:rules[1]]:
        file, func, mode = ln.split()[:3]
        rows[(file, func)] = mode
    return rows


def _site():
    """(file under the package, function) of the innermost package frame
    outside utils/precision.py."""
    f = sys._getframe(2)
    while f is not None:
        path = Path(f.f_code.co_filename)
        if PKG in path.parents and path.name != "precision.py":
            return (path.relative_to(PKG).as_posix(),
                    f.f_code.co_qualname.replace(".<locals>", ""))
        f = f.f_back
    return None


class _Record:
    """Wraps torch's product functions and methods while active (autograd
    runs the custom backwards' Python, so their products are seen too)."""

    def __init__(self):
        self.seen = {}
        self._saved = []

    def _wrap(self, f):
        def recorded(*args, **kwargs):
            site = _site()
            if site is not None:
                self.seen.setdefault(site, set()).add(precision.in_force())
            return f(*args, **kwargs)
        return recorded

    def __enter__(self):
        for owner, names in PRODUCTS.items():
            for name in names:
                f = getattr(owner, name)
                self._saved.append((owner, name, f))
                setattr(owner, name, self._wrap(f))
        return self

    def __exit__(self, *exc):
        for owner, name, f in self._saved:
            setattr(owner, name, f)


@pytest.fixture
def mode():
    """Set the mode for a test; the process's mode comes back after it,
    also when it fails."""
    prev = precision.fast_mode()
    yield precision._set_fast
    precision._set_fast(prev)
    assert precision.fast_mode() == prev


def test_import_reads_the_variable():
    """One fresh process imports the package with the variable set, then,
    its modules dropped (torch stays loaded), with it empty."""
    code = """
import os, sys, torch
def read():
    import limbo_tpu_torch as t
    print(t.utils.precision.fast_mode(),
          torch.backends.cuda.matmul.fp32_precision,
          torch.backends.cudnn.fp32_precision)
read()
for m in [m for m in sys.modules if m.startswith("limbo_tpu_torch")]:
    del sys.modules[m]
os.environ["LIMBO_TPU_FAST_MATMUL"] = ""
read()
"""
    env = dict(os.environ, LIMBO_TPU_FAST_MATMUL="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split("\n")[:2] == ["True tf32 ieee", "False ieee ieee"]


def test_exact_restores_the_mode_after_a_failure(mode):
    mode(True)
    assert precision.in_force() == "tf32"
    with pytest.raises(RuntimeError):
        with precision.exact():
            with precision.exact():
                assert precision.in_force() == "ieee"
            assert precision.in_force() == "ieee"
            raise RuntimeError
    assert precision.in_force() == "tf32"
    mode(False)
    with precision.exact():
        assert precision.in_force() == "ieee"


def _drive():
    """Every product family of the slice at a small size, on the CPU."""
    from limbo_tpu_torch.parallel import mesh as pmesh
    from limbo_tpu_torch.parallel.sharded_chol import sharded_fit

    g = torch.Generator().manual_seed(0)
    n, d = 200, 3
    X = torch.rand((n, d), generator=g)
    Y = torch.sin(3.0 * X.sum(dim=1, keepdim=True))
    kern = kernels.SquaredExpARD.create(dim=d, device="cpu")
    mean = means.DataMean.create(device="cpu")
    gp = tgp.fit(kern, mean, X, Y, capacity=256, device="cpu")
    Xq = torch.rand((16, d), generator=g)
    tgp.query(gp, Xq)
    # the solve route's cache (an f32 K^-1 queried directly), then the
    # blocked route's, as the card takes it from TRI_INV_MIN_N
    c = tgp.QueryCache.build(gp, with_Linv=True, defer_m=4)
    tgp.query_cached(gp, c, Xq)
    x, y = X[0] + 0.01, Y[0]
    tgp.add_sample_cached(gp, tgp.QueryCache.build(gp, with_K=True), x, y,
                          fast_update="refined")
    tgp.add_sample(gp, x, y)
    saved = {m: m.use_blocked_tri for m in (chol, tgp)}
    try:
        for m in saved:
            m.use_blocked_tri = lambda n, dev: True
        gq = tgp.fit(kern, mean, X, Y, capacity=256, device="cpu")
        c = tgp.QueryCache.build(gq, with_Linv=True, qdtype=torch.bfloat16,
                                 defer_m=4)
        lite = tgp.QueryCache.build(gq, with_Linv=True,
                                    qdtype=torch.bfloat16, defer_m=4,
                                    lite=True)
    finally:
        for m, f in saved.items():
            m.use_blocked_tri = f
    for k in range(5):                       # a flush at the 4th
        x = torch.rand((d,), generator=g)
        y = torch.sin(3.0 * x.sum()).reshape(1)
        gq, c = tgp.add_sample_cached(gq, c, x, y, fast_update="deferred")
    tgp.query_cached(gq, c, Xq)
    tgp.query_cached(gq, lite, Xq)
    # an ascent step's gradient through the cached query
    Z = Xq.clone().requires_grad_(True)
    mu, var = tgp.query_cached(gq, c, Z)
    (mu.sum() + var.sum()).backward()
    # the LML and its gradient, the blocked factor and its pullback
    p = kern.params.clone().requires_grad_(True)
    lml = tgp.log_marginal_likelihood(kern.with_params(p), mean, gp.x, gp.y,
                                      n)
    torch.autograd.grad(lml, p)
    A = gp.kernel.gram_train_masked(gp.x, n).requires_grad_(True)
    chol.cholesky(A, block=32, min_blocked=0).sum().backward()
    # the kernel wrappers' CPU routes (their plain versions)
    sf2, il = torch.tensor(1.0), torch.tensor(1.0)
    gram_pallas.gram_pallas(Xq, X, sf2, il)
    gram_pallas.gram_train_pallas(X, sf2, il, torch.tensor(0.01), n)
    trimv._trimv_pallas(gp.L, gp.alpha[:, 0])
    mirror.mirror_mm(torch.rand((16, 256), generator=g), c.Kinv_q)
    chol._tri_inv_panel(gp.L)
    chol.panel_factor(A.detach()[:32, :32])
    # the sharded factor at one gloo rank
    with pmesh.start_group(device="cpu"):
        sharded_fit(pmesh.make_mesh(axis_name="rows"), kern, mean,
                    gp.x, gp.y, n=n, block=32)


SQ_DIST = {True: {("utils/maths.py", "_ExactCross.forward"),
                  ("utils/maths.py", "_ExactCross.backward")},
           False: {("utils/maths.py", "sq_dist")}}
EXACT_SEEN = {*SQ_DIST[True], *SQ_DIST[False],
              ("ops/gram_pallas.py", "gram_plain"),
              ("ops/chol.py", "cholesky_blocked"),
              ("ops/chol.py", "tri_inv_blocked"),
              ("ops/chol.py", "tri_inv_panel_plain"),
              ("ops/chol.py", "_Cholesky.backward"),
              ("ops/trimv.py", "trimv"),
              ("ops/trimv.py", "trimv_plain"),
              ("ops/mirror.py", "mirror_mm_plain"),
              ("models/gp.py", "_mirror_from_linv"),
              ("models/gp.py", "_kinv_from_linv"),
              ("parallel/sharded_chol.py", "_factor_loop")}


@pytest.mark.parametrize("fast", [True, False])
def test_products_follow_the_table(mode, fast):
    table = _table()
    assert {(f, fn) for (f, fn), m in table.items() if m == "exact"} \
        == EXACT_SEEN
    mode(fast)
    rec = _Record()
    with rec:
        _drive()
    assert precision.in_force() == ("tf32" if fast else "ieee")
    unlisted = set(rec.seen) - set(table)
    assert not unlisted, unlisted
    for site, got in rec.seen.items():
        want = {"ieee"} if table[site] == "exact" or not fast else {"tf32"}
        assert got == want, (site, got)
    assert EXACT_SEEN - SQ_DIST[not fast] <= set(rec.seen)
    assert not SQ_DIST[not fast] & set(rec.seen)
    assert len(set(rec.seen) - EXACT_SEEN) >= 10


def _step_state(fast):
    precision._set_fast(fast)
    step, _, _ = bench_torch.make_step(256, 8, 1, "cpu")
    fit = (step.gp.x.clone(), step.gp.y.clone(), step.gp.L.clone(),
           step.gp.alpha.clone())
    step.step()
    state = {k: getattr(step.gp, k).clone() for k in ("x", "y", "L", "alpha")}
    state.update({k: getattr(step.cache, k).clone()
                  for k in ("Linv", "Kinv", "Kinv_q", "P", "ay", "u_ones")})
    return fit, state


def test_cpu_bits_of_the_bench_step_equal_across_modes(mode):
    fit0, off = _step_state(False)
    fit1, on = _step_state(True)
    for a, b in zip(fit0, fit1):
        assert torch.equal(a, b)
    for k in off:
        assert torch.equal(off[k], on[k]), k
