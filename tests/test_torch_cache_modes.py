"""The rest of the K^{-1} query cache against the JAX package's: the
build's ``with_K`` / ``lite`` / ``block`` forms, the panel-by-panel bf16
mirror (``_mirror_from_linv``), and the "refined", ``True`` and both lite
deferred appends.

SquaredExpARD + DataMean fitted by the reference in f64 (tests/conftest.py
enables x64) at N = 384 on 300 points, carried across with
utils/convert.py; both packages then run the same appends on the same
points.  Tolerances: f64 state and posterior to 1e-9 of the largest
entry (the two libraries sum products and solves in other orders); a bf16
mirror to one bf16 step (2^-7 relative: 8 significant bits), since an f64
difference in the last bit can round a mirror entry to the neighbouring
value, and to half a step (2^-8) of the exact product.  The lite mirror
built from Linv is reached on the CPU by taking both packages' blocked
route (their ``use_blocked_tri`` patched to true).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limbo_tpu.kernels as jk
import limbo_tpu.means as jm
from limbo_tpu.models import gp as jgp
from limbo_tpu_torch import kernels, means
from limbo_tpu_torch.models import gp as tgp
from limbo_tpu_torch.utils import convert

torch.set_num_threads(1)

# the reference jitted: one compile per form instead of one per primitive.
# Fresh closures, so a trace made under one route is never reused under
# the other (the patched use_blocked_tri is read while tracing).
_jadd = jax.jit(jgp.add_sample_cached, static_argnames=("fast_update",))
_jquery_cached = jax.jit(jgp.query_cached)


_BUILT = {}


def _jbuild(gj, route, **kw):
    """The reference's cache of the module's GP, built once per form and
    route (the build and append tests share the forms they have in
    common)."""
    key = (id(gj), route, tuple(sorted((k, str(v)) for k, v in kw.items())))
    if key not in _BUILT:
        _BUILT[key] = jax.jit(lambda g: jgp.QueryCache.build(g, **kw))(gj)
    return _BUILT[key]


D, N0, CAP = 3, 300, 384
BF16_STEP = 2.0 ** -7


def _flat(tree):
    return {"/".join(str(p) for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rel=1e-9):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _mirror_close(got, want):
    """Within one bf16 step of the reference's entry."""
    want = np.asarray(want.astype(jnp.float64))
    got = got.double().numpy()
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= BF16_STEP * np.abs(want) + 1e-30)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(5)
    X = rng.uniform(size=(N0, D))
    Y = np.sin(3.0 * X.sum(axis=1, keepdims=True)) \
        + 0.1 * rng.standard_normal((N0, 1))
    kj = jk.SquaredExpARD.create(dim=D, noise=0.01, dtype=jnp.float64)
    kj = kj.replace(log_ell=jnp.log(jnp.array([0.4, 0.6, 0.5])))
    gj = jax.jit(jgp.fit, static_argnames=("capacity",))(
        kj, jm.DataMean.create(dtype=jnp.float64), jnp.asarray(X),
        jnp.asarray(Y), capacity=CAP)
    pts = rng.uniform(size=(12, D))
    return gj, pts


def _port(gj):
    return convert.to_gp(_flat(gj), kernels.SquaredExpARD.create(
        dim=D, device="cpu", dtype=torch.float64),
        means.DataMean.create(device="cpu", dtype=torch.float64),
        device="cpu")


def _blocked(monkeypatch):
    monkeypatch.setattr(jgp, "use_blocked_tri", lambda n: True)
    monkeypatch.setattr(tgp, "use_blocked_tri", lambda n, dev: True)


def _cache_fields(cj, ct, mirror_bf16=False):
    for name in ("Kinv", "K", "Linv", "Kinv_q", "P", "ay", "u_ones"):
        a, b = getattr(cj, name), getattr(ct, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        if name == "Kinv_q" and mirror_bf16:
            assert b.dtype == torch.bfloat16
            _mirror_close(b, a)
        else:
            _close(b, a)
    assert (cj.base_n is None) == (ct.base_n is None)
    if ct.base_n is not None:
        assert ct.base_n == int(cj.base_n) == int(ct.base_n_dev)


@pytest.mark.parametrize("kw,route", [
    (dict(with_K=True), "panels"),
    (dict(with_K=True, with_Linv=True, block=100), "panels"),
    (dict(with_Linv=True, defer_m=5, lite=True), "panels"),
    (dict(with_Linv=True, defer_m=5, lite=True, qdtype="bf16"), "panels"),
    (dict(with_Linv=True, defer_m=5, lite=True, qdtype="bf16"), "blocked"),
])
def test_build_forms_equal_reference(pair, monkeypatch, kw, route):
    """Every field of the cache, f64 to 1e-9 (a bf16 mirror to one bf16
    rounding).  "panels" is the library route, on which the reference
    solves for Linv in panels (``block`` = 100: 4 of 96 columns) and the
    port in one solve; "blocked" is the blocked inverse's route."""
    gj, _ = pair
    if route == "blocked":
        _blocked(monkeypatch)
    bf16 = kw.get("qdtype") == "bf16"
    jkw = dict(kw, qdtype=jnp.bfloat16) if bf16 else kw
    tkw = dict(kw, qdtype=torch.bfloat16) if bf16 else kw
    cj = _jbuild(gj, route, **jkw)
    ct = tgp.QueryCache.build(_port(gj), **tkw)
    _cache_fields(cj, ct, bf16)
    if kw.get("lite"):
        assert ct.Kinv is None and ct.K is None


def test_mirror_from_linv_in_panels(pair):
    """Several panels (cap 100: 4 of 96) and one (the reference's cap,
    1024) give the reference's mirror to one bf16 step, and the exact
    product Linv^T Linv to half a step (round to nearest); ``out`` is
    written in place."""
    gj, _ = pair
    Linv = tgp.tri_inv(_port(gj).L)
    assert tgp._panel_width(CAP, 100) == 96
    ref = jax.jit(jgp._mirror_from_linv, static_argnums=1)(
        jnp.asarray(Linv.numpy()), jnp.bfloat16)
    exact = (Linv.T @ Linv).numpy()
    out = torch.full((CAP, CAP), torch.nan, dtype=torch.bfloat16)
    got = tgp._mirror_from_linv(Linv, torch.bfloat16, out=out, cap=100)
    assert got is out
    for m in (got, tgp._mirror_from_linv(Linv, torch.bfloat16)):
        _mirror_close(m, ref)
        m = m.double().numpy()
        assert np.all(np.abs(m - exact)
                      <= BF16_STEP / 2 * np.abs(exact) * (1 + 1e-12))
    # the ragged width rule of the reference: a divisor of N
    for N, cap in ((33280, 1024), (1280, 1024), (97, 10)):
        w = tgp._panel_width(N, cap)
        assert N % w == 0 and w == jgp._panel_width(N, cap)


def _run_appends(gj, ct_kw, mode, pts, monkeypatch, route):
    """The same appends through both packages; returns both states."""
    if route == "blocked":
        _blocked(monkeypatch)
    gt = _port(gj)
    jkw = dict(ct_kw)
    tkw = dict(ct_kw)
    if ct_kw.get("qdtype") == "bf16":
        jkw["qdtype"], tkw["qdtype"] = jnp.bfloat16, torch.bfloat16
    cj = _jbuild(gj, route, **jkw)
    ct = tgp.QueryCache.build(gt, **tkw)
    for x in pts:
        y = np.array([np.sin(3.0 * x.sum())])
        gj, cj = _jadd(gj, cj, jnp.asarray(x), jnp.asarray(y),
                       fast_update=mode)
        gt, ct = tgp.add_sample_cached(gt, ct, torch.from_numpy(x),
                                       torch.from_numpy(y), fast_update=mode)
    return gj, cj, gt, ct


@pytest.mark.parametrize("mode,kw,route", [
    ("refined", dict(with_K=True), "panels"),
    ("refined", dict(with_K=True, qdtype="bf16"), "panels"),
    (True, dict(), "panels"),
    ("deferred", dict(with_Linv=True, defer_m=5, lite=True), "panels"),
    ("deferred", dict(with_Linv=True, defer_m=5, lite=True, qdtype="bf16"),
     "blocked"),
])
def test_appends_equal_reference(pair, monkeypatch, mode, kw, route):
    """12 appends (two flushes at defer_m = 5): the GP, every cache field
    and the cached posterior at 9 points, f64 to 1e-9 (a bf16 mirror to
    one bf16 rounding, and the posterior through it to 1e-6 of the prior
    variance, its rounding through the quadratic form)."""
    gj, pts = pair
    gj, cj, gt, ct = _run_appends(gj, kw, mode, pts, monkeypatch, route)
    assert gt.n == int(gj.n) == N0 + len(pts)
    for name in ("x", "y", "L", "alpha"):
        _close(getattr(gt, name), getattr(gj, name))
    bf16 = kw.get("qdtype") == "bf16"
    _cache_fields(cj, ct, bf16)
    if mode == "deferred":
        assert ct.base_n == N0 + 10 and ct.Kinv is None
    Xq = np.random.default_rng(1).uniform(size=(9, D))
    mj, vj = _jquery_cached(gj, cj, jnp.asarray(Xq))
    mt, vt = tgp.query_cached(gt, ct, torch.from_numpy(Xq))
    _close(mt, mj)
    _close(vt, vj, rel=1e-6 if bf16 else 1e-9)


def test_refined_pivot_is_the_solve_pivot(pair):
    """The refined append's state against the solve append's (the
    reference's drift claim, tests/test_gp.py:496-520): the bordered
    inverse and alpha to 1e-9 after 12 appends."""
    gj, pts = pair
    states = []
    for mode in ("refined", False):
        gt = _port(gj)
        ct = tgp.QueryCache.build(gt, with_K=True)
        for x in pts:
            y = np.array([np.sin(3.0 * x.sum())])
            gt, ct = tgp.add_sample_cached(gt, ct, torch.from_numpy(x),
                                           torch.from_numpy(y),
                                           fast_update=mode)
        states.append((gt, ct))
    (gr, cr), (gs, cs) = states
    _close(cr.Kinv, cs.Kinv.numpy())
    _close(gr.alpha, gs.alpha.numpy())
    # K was bordered in place: the training covariance of the stored data
    K = gr.kernel.gram_train_masked(gr.x, gr.n)
    _close(cr.K, K.numpy())


def test_raw_and_refined_refusals(pair):
    """True refuses a cache with Linv (it would write drift-prone rows into
    it), "refined" one without K, and lite needs Linv and defer_m."""
    gj, pts = pair
    gt = _port(gj)
    x, y = torch.from_numpy(pts[0]), torch.ones(1, dtype=torch.float64)
    with pytest.raises(ValueError, match="Linv"):
        tgp.add_sample_cached(gt, tgp.QueryCache.build(gt, with_Linv=True),
                              x, y, fast_update=True)
    with pytest.raises(ValueError, match="with_K"):
        tgp.add_sample_cached(gt, tgp.QueryCache.build(gt), x, y,
                              fast_update="refined")
    for kw in (dict(with_Linv=True, lite=True), dict(defer_m=4, lite=True)):
        with pytest.raises(ValueError, match="lite"):
            tgp.QueryCache.build(gt, **kw)


def test_chip_smoke_modes_checks_and_controls():
    """chip_smoke.py's modes_held on an f32 state (N = 384, 300 points, 12
    refined and 12 True appends): K and both pivots pass their limits, and
    each control (K with an unwritten border column, the refined pivot
    from it, the raw pivot against the refined limit) misses it; a pivot
    route with its refinement step left out is refused."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    rng = np.random.default_rng(8)
    X = torch.from_numpy(rng.uniform(size=(N0, D))).float()
    Y = torch.sin(3.0 * X.sum(1, keepdim=True))
    k = kernels.SquaredExpARD.create(dim=D, noise=0.01, device="cpu")
    states = []
    for mode, kw in (("refined", dict(with_K=True)), (True, {})):
        g = tgp.fit(k, means.DataMean.create(device="cpu"), X, Y,
                    capacity=CAP, device="cpu")
        c = tgp.QueryCache.build(g, qdtype=torch.bfloat16, **kw)
        for x in torch.from_numpy(rng.uniform(size=(12, D))).float():
            g, c = tgp.add_sample_cached(g, c, x, torch.sin(3 * x.sum())[None],
                                         fast_update=mode)
        states += [g, c]
    x = torch.from_numpy(rng.uniform(size=(1, D))).float()
    out = chip_smoke.modes_held(tgp, *states, x)
    for key in ("K", "pivot_true", "pivot_refined"):
        assert out[f"{key}_in_limit"] <= 1.0
    assert min(out["control_K_missed"], out["control_pivot_missed"],
               out["control_raw_missed"]) > 0

    class Unrefined:
        def __getattr__(self, name):
            return getattr(tgp, name)

        @staticmethod
        def _pivot(gp, cache, k_vec, mode):
            return tgp._pivot(gp, cache, k_vec, True)

    with pytest.raises(AssertionError, match="refined pivot"):
        chip_smoke.modes_held(Unrefined(), *states, x)
