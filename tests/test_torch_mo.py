"""The multi-objective slice against the JAX package's: the Pareto and EHVI
ops, the native hypervolume / EHVI library, NSGA-II, the Ehvi / Nsbo /
Parego loops, the multi-objective stats writers, and the GPBasic / GPOpt
factories.

Inputs are made from a seed with NumPy and run through both packages in
f64 on the CPU (tests/conftest.py enables x64 for the reference).  Fronts
carry padded rows, duplicated points and points clipped at the reference
point.  Tolerances: masks exactly; volumes, EHVI, boxes and q-EHVI to
1e-12 relative (the two libraries sum in other orders); EHVI gradients to
1e-10; one Ehvi step's proposal to 1e-8.  Where the reference draws
(NSGA-II's variation, the q > 1 seeds, the MC samples), the port is handed
the reference's draws; whole loops are held to the reference tests' own
assertions (tests/test_mo_bo.py, tests/test_qehvi_exact.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limbo_tpu.bo.mo_stats as jstats
import limbo_tpu.kernels as jk
import limbo_tpu.means as jm
import limbo_tpu.native as jnative
import limbo_tpu.ops.ehvi as jehvi
import limbo_tpu.ops.pareto as jpareto
import limbo_tpu.opt.nsga2 as jnsga
from limbo_tpu.bo.multi import Ehvi as JEhvi
from limbo_tpu.models import multi_gp as jmulti
from limbo_tpu.opt.gradient import Rprop as JRprop
from limbo_tpu_torch import kernels, native
from limbo_tpu_torch.bo import mo_stats
from limbo_tpu_torch.bo.multi import BoMulti, Ehvi, Nsbo, Parego
from limbo_tpu_torch.bo.stop import MaxIterations
from limbo_tpu_torch.models import multi_gp
from limbo_tpu_torch.ops import ehvi, pareto
from limbo_tpu_torch.opt import nsga2
from limbo_tpu_torch.opt.gradient import Rprop

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(got, want, rtol=1e-12, atol=1e-300):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _front(rng, k, p, ref, pad=3):
    """k mutually non-dominated points above ref (maximization), one of
    them duplicated and one below ref in its first objective (clipped),
    then `pad` padded rows of garbage; returns (front, mask)."""
    if p == 2:
        t = np.sort(rng.uniform(0.1, 0.9, size=k))
        F = np.stack([t, 1.0 - t ** 1.5], axis=1)
    else:
        u = rng.uniform(0.1, 1.4, size=(k, 2))
        F = np.stack([np.cos(u[:, 0]) * np.cos(u[:, 1]),
                      np.cos(u[:, 0]) * np.sin(u[:, 1]),
                      np.sin(u[:, 0])], axis=1)
    F = F + np.asarray(ref)
    F[1] = F[0]                                   # a tie
    F[-1, 0] = ref[0] - 0.05                      # clipped at ref
    garbage = rng.uniform(2.0, 3.0, size=(pad, p))
    return (np.concatenate([F, garbage]),
            np.concatenate([np.ones(k), np.zeros(pad)]))


# ---------------------------------------------------------------------------
# the Pareto ops
# ---------------------------------------------------------------------------

_jdom = jax.jit(jpareto.dominance_matrix)
_jnd = jax.jit(jpareto.non_dominated_mask)
_jset = jax.jit(jpareto.pareto_set)
_jhv2 = jax.jit(jpareto.hypervolume_2d)


def test_pareto_masks_sets_and_volumes_equal_reference():
    """dominance, the front mask and the compacted set exactly, on Y with
    ties and a padding mask; the 2-D hypervolume (masked, batched) to
    1e-12; hypervolume at 3 objectives through the native sweep."""
    rng = np.random.default_rng(0)
    Y = np.round(rng.uniform(size=(40, 2)), 1)     # many ties
    X = rng.uniform(size=(40, 3))
    mask = (rng.uniform(size=40) > 0.2).astype(np.float64)
    for m in (None, mask):
        jm_ = None if m is None else jnp.asarray(m)
        tm = None if m is None else _t(m)
        np.testing.assert_array_equal(
            pareto.non_dominated_mask(_t(Y), tm).numpy(),
            np.asarray(_jnd(jnp.asarray(Y), jm_)))
    jmask, tmask = jnp.asarray(mask), _t(mask)
    np.testing.assert_array_equal(
        pareto.dominance_matrix(_t(Y), tmask).numpy(),
        np.asarray(_jdom(jnp.asarray(Y), jmask)))
    got = pareto.pareto_set(_t(X), _t(Y), tmask)
    want = _jset(jnp.asarray(X), jnp.asarray(Y), jmask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ref = np.array([0.05, -0.1])
    _close(pareto.hypervolume_2d(_t(Y), _t(ref), tmask),
           _jhv2(jnp.asarray(Y), jnp.asarray(ref), jmask))
    # batched over a leading axis: each row its own volume
    Yb = rng.uniform(size=(3, 40, 2))
    got = pareto.hypervolume_2d(_t(Yb), _t(ref), tmask.expand(3, -1))
    for i in range(3):
        _close(got[i], _jhv2(jnp.asarray(Yb[i]), jnp.asarray(ref), jmask))
    Y3 = rng.uniform(size=(15, 3))
    _close(pareto.hypervolume(_t(Y3), [0.1, 0.0, 0.2], _t(mask[:15])),
           jpareto.hypervolume(jnp.asarray(Y3), np.array([0.1, 0.0, 0.2]),
                               jnp.asarray(mask[:15])))


# ---------------------------------------------------------------------------
# EHVI
# ---------------------------------------------------------------------------

_j2 = jax.jit(jax.vmap(jehvi.ehvi_2d_max, in_axes=(0, 0, None, None, None)))
_j3 = jax.jit(jax.vmap(jehvi.ehvi_3d_max, in_axes=(0, 0, None, None, None)))
_jmax_grad = jax.jit(jax.vmap(
    jax.value_and_grad(jehvi.ehvi_max, argnums=(0, 1)),
    in_axes=(0, 0, None, None, None)))


@pytest.mark.parametrize("p", [2, 3])
def test_ehvi_and_boxes_equal_reference(p):
    """The boxes, exact EHVI (the 2-D stripes both ways and the box path),
    ehvi_max_batch and the autograd gradient of ehvi_max, on a padded
    front with a tie and a clipped point, for 6 candidates at once."""
    rng = np.random.default_rng(p)
    ref = np.full(p, -0.2)
    F, fm = _front(rng, 7, p, ref)
    mu = rng.uniform(-0.1, 1.2, size=(6, p))
    sg = rng.uniform(0.05, 0.5, size=(6, p))
    jF, jfm, jref = jnp.asarray(F), jnp.asarray(fm), jnp.asarray(ref)
    boxes = (ehvi.nondominated_boxes_2d if p == 2
             else ehvi.nondominated_boxes_3d)
    jboxes = (jehvi.nondominated_boxes_2d if p == 2
              else jehvi.nondominated_boxes_3d)
    for g, w in zip(boxes(-_t(F), -_t(ref), _t(fm)),
                    jboxes(-jF, -jref, jfm)):
        _close(g, w)
    if p == 2:
        _close(ehvi.ehvi_2d_max(_t(mu), _t(sg), _t(F), _t(ref), _t(fm)),
               _j2(jnp.asarray(mu), jnp.asarray(sg), jF, jref, jfm))
        # the minimization form the maximization one negates into
        _close(ehvi.ehvi_2d_min(_t(-mu), _t(sg), _t(-F), _t(-ref), _t(fm)),
               ehvi.ehvi_2d_max(_t(mu), _t(sg), _t(F), _t(ref), _t(fm)))
    else:
        _close(ehvi.ehvi_3d_max(_t(mu), _t(sg), _t(F), _t(ref), _t(fm)),
               _j3(jnp.asarray(mu), jnp.asarray(sg), jF, jref, jfm))
    want, (gm, gs) = _jmax_grad(jnp.asarray(mu), jnp.asarray(sg), jF, jref,
                                jfm)
    _close(ehvi.ehvi_max(_t(mu), _t(sg), _t(F), _t(ref), _t(fm)), want)
    _close(ehvi.ehvi_max_batch(_t(mu), _t(sg), _t(F), _t(ref), _t(fm)),
           want)
    tm, ts = _t(mu).requires_grad_(True), _t(sg).requires_grad_(True)
    ehvi.ehvi_max(tm, ts, _t(F), _t(ref), _t(fm)).sum().backward()
    _close(tm.grad, gm, rtol=1e-10)
    _close(ts.grad, gs, rtol=1e-10)


_jqehvi = jax.jit(jax.vmap(jehvi.qehvi_exact_max,
                           in_axes=(0, 0, None, None, None, None)),
                  static_argnums=5)
_jqmc = jax.jit(jehvi.qehvi_mc_max)


@pytest.mark.parametrize("p,q", [(2, 3), (3, 2)])
def test_qehvi_exact_and_mc_equal_reference(p, q):
    """qehvi_exact_max (gh 8) on correlated joint covariances, for a batch
    of two candidate batches at once, and qehvi_mc_max on the same
    samples, to 1e-12."""
    rng = np.random.default_rng(10 * p + q)
    ref = np.full(p, -0.2)
    F, fm = _front(rng, 5, p, ref)
    mu = rng.uniform(0.2, 0.9, size=(2, q, p))
    A = rng.normal(size=(2, p, q, q)) * 0.15
    cov = A @ np.swapaxes(A, -1, -2) + 0.01 * np.eye(q)
    _close(ehvi.qehvi_exact_max(_t(mu), _t(cov), _t(F), _t(ref), _t(fm),
                                gh_nodes=8),
           _jqehvi(jnp.asarray(mu), jnp.asarray(cov), jnp.asarray(F),
                   jnp.asarray(ref), jnp.asarray(fm), 8))
    Ys = rng.normal(size=(64, q, p)) * 0.2 + mu[0][None]
    _close(ehvi.qehvi_mc_max(_t(Ys), _t(F), _t(ref), _t(fm)),
           _jqmc(jnp.asarray(Ys), jnp.asarray(F), jnp.asarray(ref),
                 jnp.asarray(fm)))


@pytest.mark.parametrize("p", [2, 3])
def test_ehvi_mc_equals_reference_on_its_samples(p):
    """ehvi_mc_max's estimator given the reference's own normals (its
    key's draws) equals the reference's value; the port's own draws
    come from a torch.Generator."""
    rng = np.random.default_rng(20 + p)
    ref = np.full(p, -0.2)
    F, fm = _front(rng, 5, p, ref)
    mu, sg = rng.uniform(0.2, 0.9, size=p), rng.uniform(0.1, 0.3, size=p)
    key = jax.random.PRNGKey(p)
    want = jax.jit(jehvi.ehvi_mc_max, static_argnames="n_samples")(
        key, jnp.asarray(mu), jnp.asarray(sg), jnp.asarray(F),
        jnp.asarray(ref), jnp.asarray(fm), n_samples=256)
    eps = np.asarray(jax.random.normal(key, (256, p), dtype=jnp.float64))
    _close(ehvi._ehvi_mc(_t(mu) + _t(sg) * _t(eps), _t(F), _t(ref), _t(fm)),
           want)
    g = torch.Generator().manual_seed(0)
    v = ehvi.ehvi_mc_max(g, _t(mu), _t(sg), _t(F), _t(ref), _t(fm),
                         n_samples=4096)
    exact = ehvi.ehvi_max(_t(mu), _t(sg), _t(F), _t(ref), _t(fm))
    np.testing.assert_allclose(float(v), float(exact), rtol=0.1, atol=2e-3)


# ---------------------------------------------------------------------------
# the native library
# ---------------------------------------------------------------------------

def test_native_equals_numpy_and_reference_native():
    """The port's own build of hv.cc / ehvi.cc against its NumPy and
    ops.ehvi plain versions and against the reference's native functions:
    hypervolume (2 to 4 objectives), the non-dominated filter, exact 2-D
    and 3-D EHVI, and the MC EHVI (the same seed, the same stream)."""
    assert native.lib_path().exists() or native.build().exists()
    rng = np.random.default_rng(5)
    for d in (2, 3, 4):
        Y = np.round(rng.uniform(size=(25, d)), 1)
        ref = np.full(d, 0.05)
        v = native.hv_host(Y, ref)
        _close(v, native._hv_numpy(Y, ref))
        _close(v, jnative.hv_host(Y, ref))
        keep = native.filter_nondominated_host(Y)
        np.testing.assert_array_equal(keep,
                                      native._filter_nondominated_numpy(Y))
        np.testing.assert_array_equal(keep,
                                      jnative.filter_nondominated_host(Y))
    for p, host, plain, jhost in (
            (2, native.ehvi2d_host, native._ehvi2d_plain, jnative.ehvi2d_host),
            (3, native.ehvi3d_host, native._ehvi3d_plain,
             jnative.ehvi3d_host)):
        ref = np.full(p, -0.2)
        F, fm = _front(rng, 6, p, ref, pad=0)
        F = F[native.filter_nondominated_host(F)]
        mu = rng.uniform(-0.1, 1.2, size=(5, p))
        sg = rng.uniform(0.05, 0.5, size=(5, p))
        v = host(mu, sg, F, ref)
        _close(v, plain(mu, sg, F, ref), rtol=1e-10)
        _close(v, jhost(mu, sg, F, ref), rtol=1e-12)
    F = rng.uniform(size=(6, 3))
    F = F[native.filter_nondominated_host(F)]
    mu, sg = np.full(3, 0.6), np.full(3, 0.2)
    _close(native.ehvi_mc_host(mu, sg, F, np.zeros(3), 2000, seed=7),
           jnative.ehvi_mc_host(mu, sg, F, np.zeros(3), 2000, seed=7))
    exact = native.ehvi3d_host(mu[None], sg[None], F, np.zeros(3))[0]
    np.testing.assert_allclose(
        native.ehvi_mc_host(mu, sg, F, np.zeros(3), 4000), exact, rtol=0.1)
    np.testing.assert_allclose(
        native._ehvi_mc_numpy(mu, sg, F, np.zeros(3), 2000), exact,
        rtol=0.1)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No silent fallback: a compiler that fails makes the build raise."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", ["-O3", "-std=c++17", "-fPIC",
                                              "-shared", "-DX=\"", "-x",
                                              "nonexistent-language"])
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()


# ---------------------------------------------------------------------------
# NSGA-II
# ---------------------------------------------------------------------------

_jranks = jax.jit(jnsga._ranks)
# the reference's crowding runs eagerly: compiled, XLA's CPU backend fuses
# rank * 1e30 + y into one FMA, which rounds the keys of some ranks past 0
# apart where the separate product and sum of eager JAX (and of PyTorch)
# tie them
_jcrowd = jnsga._crowding


def test_nsga2_ranks_and_crowding_equal_reference():
    """Ranks and crowding distances on Y with many fronts and ties (so the
    1e30 sort keys of every rank past 0 tie and fall to the index), 2 and
    3 objectives, in populations that need fewer (5 fronts) and more (12)
    peels than the 8 between two checks."""
    rng = np.random.default_rng(0)
    for P, M in ((40, 2), (40, 3)):
        Y = np.round(rng.uniform(size=(P, M)), 1)
        r = nsga2._ranks(_t(Y))
        np.testing.assert_array_equal(r.numpy(),
                                      np.asarray(_jranks(jnp.asarray(Y))))
        assert int(r.max()) >= 3
        _close(nsga2._crowding(_t(Y), r),
               _jcrowd(jnp.asarray(Y), jnp.asarray(r.numpy())))


def test_nsga2_variation_equals_reference_on_its_draws():
    """_tournament, _sbx and _poly_mutation given the reference's draws
    (its keys' randint and uniforms), and one whole generation."""
    rng = np.random.default_rng(3)
    P, d = 20, 3
    X = rng.uniform(size=(P, d))
    Y = np.stack([np.sin(3 * X.sum(1)), np.cos(2 * X[:, 0])], axis=1)
    # the parents' ranks and crowding from the port (held to the
    # reference's above), as the reference's tournament takes them
    r = nsga2._ranks(_t(Y))
    rank = jnp.asarray(r.numpy())
    crowd = jnp.asarray(nsga2._crowding(_t(Y), r).numpy())
    k = jax.random.PRNGKey(4)
    k_sel, k_cx, k_mut = jax.random.split(k, 3)
    want = jax.jit(jnsga._tournament, static_argnums=3)(k_sel, rank, crowd,
                                                        2 * P)
    idx = jax.random.randint(k_sel, (2, 2 * P), 0, P)
    got = nsga2._tournament(torch.tensor(np.asarray(rank)), _t(crowd),
                            torch.tensor(np.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    par = np.asarray(want)
    X1, X2 = X[par[:P]], X[par[P:]]
    child = jax.jit(jnsga._sbx)(k_cx, jnp.asarray(X1), jnp.asarray(X2), 15.0)
    u = jax.random.uniform(k_cx, X1.shape, dtype=jnp.float64)
    c = nsga2._sbx(_t(u), _t(X1), _t(X2), 15.0)
    _close(c, child)
    mut = jax.jit(jnsga._poly_mutation)(k_mut, child, 20.0)
    k1, k2 = jax.random.split(k_mut)
    u1 = jax.random.uniform(k1, X1.shape, dtype=jnp.float64)
    u2 = jax.random.uniform(k2, X1.shape, dtype=jnp.float64)
    m = nsga2._poly_mutation(_t(u1), _t(u2), c, 20.0)
    _close(m, mut)

    def fun(X):
        return torch.stack([torch.sin(3 * X.sum(1)), torch.cos(2 * X[:, 0])],
                           dim=1)

    ea = nsga2.Nsga2(pop_size=P, generations=1)
    Xn, Yn = ea.generation(fun, _t(X), _t(Y), torch.tensor(np.asarray(idx)),
                           _t(u), _t(u1), _t(u2))
    # the reference's selection over the union with the same child
    Xu = np.concatenate([X, m.numpy()])
    Yu = np.concatenate([Y, fun(m).numpy()])
    ru = _jranks(jnp.asarray(Yu))
    cu = _jcrowd(jnp.asarray(Yu), ru)
    order = np.asarray(jnp.argsort(ru.astype(jnp.float64) * jnsga.BIG
                                   - jnp.minimum(cu, jnsga.BIG / 2)))[:P]
    np.testing.assert_array_equal(Xn.numpy(), Xu[order])
    np.testing.assert_array_equal(Yn.numpy(), Yu[order])


def _schaffer_front_hv():
    t = np.linspace(0, 2, 200)
    F = np.stack([1 - t ** 2 / 4, 1 - (t - 2) ** 2 / 4], axis=1)
    return float(pareto.hypervolume_2d(_t(F), _t([-1.0, -1.0])))


def schaffer_max(x):
    v = float(np.atleast_1d(x)[0]) * 2.0
    return np.array([1.0 - v ** 2 / 4.0, 1.0 - (v - 2.0) ** 2 / 4.0])


def test_nsga2_finds_schaffer_front():
    """tests/test_mo_bo.py's bounds: >= 20 on the front, spread over the
    whole trade-off, hypervolume > 0.95 of the true front's."""
    def objs(X):
        v = X[:, 0] * 2.0
        return torch.stack([1.0 - v ** 2 / 4.0, 1.0 - (v - 2.0) ** 2 / 4.0],
                           dim=1)

    ea = nsga2.Nsga2(pop_size=48, generations=40)
    X, Y = ea(objs, 1, torch.Generator().manual_seed(0), dtype=torch.float64)
    nd = pareto.non_dominated_mask(Y)
    assert int(nd.sum()) >= 20
    xs = X[nd][:, 0]
    assert float(xs.min()) < 0.12 and float(xs.max()) > 0.88
    hv = float(pareto.hypervolume_2d(Y[nd], _t([-1.0, -1.0])))
    assert hv > 0.95 * _schaffer_front_hv()


def test_nsga2_mesh_raises():
    """A mesh axis the mesh lacks raises; the mesh's own axis (one gloo
    rank here) splits the evaluation and keeps the unsplit run's bits."""
    from limbo_tpu_torch.parallel.mesh import make_mesh, start_group

    def objs(X):
        return torch.stack([-X.sum(dim=1), X.sum(dim=1)], dim=1)

    with start_group(device="cpu"):
        mesh = make_mesh(axis_name="pop")
        with pytest.raises(ValueError, match="no axis 'rows'"):
            nsga2.Nsga2(pop_size=8, generations=2, mesh=mesh,
                        mesh_axis="rows")(objs, 2,
                                          torch.Generator().manual_seed(0))
        split = nsga2.Nsga2(pop_size=8, generations=2, mesh=mesh)(
            objs, 2, torch.Generator().manual_seed(0))
    whole = nsga2.Nsga2(pop_size=8, generations=2)(
        objs, 2, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(split, whole))


# ---------------------------------------------------------------------------
# the loops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mo_models():
    """One 2-objective MultiGP (Matern-5/2, NullMean, 14 points in d = 2,
    capacity 64) in both packages, and its data."""
    from limbo_tpu_torch.means import NullMean

    rng = np.random.default_rng(31)
    X = rng.uniform(size=(14, 2))
    Y = np.stack([np.sin(3 * X.sum(1)), np.cos(3 * X[:, 0]) - X[:, 1]],
                 axis=1)
    jmodel = jax.jit(jmulti.fit, static_argnames="capacity")(
        jk.MaternFiveHalves.create(dtype=jnp.float64),
        jm.NullMean(dim_out=2), jnp.asarray(X), jnp.asarray(Y), capacity=64)
    tmodel = multi_gp.fit(kernels.MaternFiveHalves.create(**F64),
                          NullMean(dim_out=2), _t(X), _t(Y), capacity=64,
                          **F64)
    return X, Y, jmodel, tmodel


@pytest.mark.parametrize("q", [1, 2])
def test_ehvi_step_equals_reference(q, mo_models):
    """One Ehvi step on the same MultiGP and padded front (Rprop(8) from
    every front seed; at q = 2 the seeds moved by the reference's own
    normals) proposes the reference's point, and its value, to 1e-8."""
    X, Y, jmodel, tmodel = mo_models
    ref = (-1.5, -2.5)
    jl = JEhvi(ref=ref, q=q, gh_nodes=8, inner_opt=JRprop(iterations=8),
               dtype=jnp.float64)
    tl = Ehvi(ref=ref, q=q, gh_nodes=8, inner_opt=Rprop(iterations=8), **F64)
    for lp in (jl, tl):
        lp.X, lp.Y = list(X), list(Y)
    fx, fy, fm = tl.padded_front(2)
    assert 3 <= int(fm.sum()) < 64
    key = jax.random.PRNGKey(q)
    step = jl._build_step(64) if q == 1 else jl._build_step_batch(2)
    xj, vj = step(jmodel, jnp.asarray(fy.numpy()), jnp.asarray(fx.numpy()),
                  jnp.asarray(fm.numpy()), key)
    if q == 1:
        seeds = fx
    else:
        k_jit, _ = jax.random.split(key)
        eps = jax.random.normal(k_jit, (64, q, 2), dtype=jnp.float64)
        seeds = tl.seeds_from(fx, _t(eps))
    xt, vt = tl.step(tmodel, fy, fm, seeds)
    _close(xt, xj, rtol=0, atol=1e-8)
    _close(vt, vj, rtol=1e-8)


def test_ehvi_loop_improves_hypervolume():
    """tests/test_mo_bo.py's Ehvi assertions on Schaffer."""
    bo = Ehvi(ref=(-1.0, -1.0), stop=(MaxIterations(10),), **F64)
    Xp, Yp = bo.optimize(schaffer_max, dim=1,
                         generator=torch.Generator().manual_seed(1))
    assert len(Xp) >= 3
    hv = float(pareto.hypervolume_2d(_t(Yp), _t([-1.0, -1.0])))
    assert hv > 0.85 * _schaffer_front_hv()


def test_ehvi_batch_loop_proposes_q_points():
    """tests/test_qehvi_exact.py's batch-loop assertions: q points an
    iteration, a 2-objective front."""
    def f(x):
        t = float(np.clip(x[0], 0, 1))
        return np.asarray([np.sin(0.5 * np.pi * t), np.cos(0.5 * np.pi * t)])

    loop = Ehvi(ref=(-0.1, -0.1), q=2, gh_nodes=8,
                inner_opt=Rprop(iterations=15), stop=(MaxIterations(3),),
                **F64)
    Xp, Yp = loop.optimize(f, dim=2,
                           generator=torch.Generator().manual_seed(0))
    assert len(loop.X) == 10 + 3 * 2
    assert Yp.shape[1] == 2 and len(Yp) >= 1


def test_nsbo_loop_and_pareto_model():
    """tests/test_mo_bo.py's Nsbo and BoMulti.pareto_model assertions."""
    from limbo_tpu_torch.opt import Nsga2

    bo = Nsbo(n_objs=2, stop=(MaxIterations(5),),
              nsga2=Nsga2(pop_size=32, generations=10), **F64)
    Xp, Yp = bo.optimize(schaffer_max, dim=1,
                         generator=torch.Generator().manual_seed(2))
    assert len(Xp) >= 2 and np.all(np.isfinite(Yp))
    rng = np.random.default_rng(42)
    bm = BoMulti(n_objs=2, nsga2=Nsga2(pop_size=32, generations=10), **F64)
    for _ in range(12):
        x = rng.uniform(size=1)
        bm.add_sample(x, schaffer_max(x))
    bm.update_models()
    Xm, mu, var = bm.pareto_model(torch.Generator().manual_seed(5))
    assert Xm.shape[1] == 1 and mu.shape[1] == 2 and var.shape[1] == 2
    assert len(Xm) >= 2


def test_parego_scalarization_and_loop():
    """The scalarization given lambda equals the reference's; the loop
    meets tests/test_mo_bo.py's Parego assertions."""
    from limbo_tpu.bo.multi import Parego as JParego

    rng = np.random.default_rng(6)
    Y, lam = rng.normal(size=(9, 3)), rng.uniform(size=3)
    lam = lam / lam.sum()
    _close(Parego(n_objs=3, **F64)._scalarize(Y, lam),
           JParego(n_objs=3)._scalarize(Y, lam))
    bo = Parego(n_objs=2, iterations=12, **F64)
    Xp, Yp = bo.optimize(schaffer_max, dim=1,
                         generator=torch.Generator().manual_seed(3))
    hv = float(pareto.hypervolume_2d(_t(Yp), _t([-1.0, -1.0])))
    assert hv > 1.0 and len(Xp) >= 3


# ---------------------------------------------------------------------------
# the stats writers
# ---------------------------------------------------------------------------

class _Loop:
    """What the writers read of a loop: X, Y, the iteration, the result
    directory and a fixed model front."""

    def __init__(self, X, Y, res_dir, model_front):
        self.X, self.Y, self.iteration = list(X), list(Y), 3
        self.res_dir, self.stats_enabled = res_dir, True
        self.device = torch.device("cpu")
        self._mf = model_front

    def pareto_model(self, generator):
        return self._mf

    def pareto_data(self):
        keep = native.filter_nondominated_host(np.stack(self.Y))
        return np.stack(self.X)[keep], np.stack(self.Y)[keep]


def test_mo_stats_files_equal_reference(tmp_path):
    """HyperVolume, ParetoFront and ParetoBenchmark write the reference's
    files byte for byte on the same X, Y and model front."""
    rng = np.random.default_rng(8)
    X, Y = rng.uniform(size=(20, 2)), rng.uniform(size=(20, 3))
    mf = (rng.uniform(size=(4, 2)), rng.normal(size=(4, 3)),
          rng.uniform(size=(4, 3)))

    def true_fn(x):
        return np.array([x[0], x[1], x[0] * x[1]])

    dirs = {}
    for name, mod in (("port", mo_stats), ("ref", jstats)):
        d = tmp_path / name
        d.mkdir()
        loop = _Loop(X, Y, str(d), mf)
        for stat in (mod.HyperVolume([0.1, 0.0, 0.2]), mod.ParetoFront(),
                     mod.ParetoBenchmark(true_fn)):
            stat(loop)
        dirs[name] = d
    names = sorted(os.listdir(dirs["ref"]))
    assert names == sorted(os.listdir(dirs["port"])) and len(names) == 6
    for n in names:
        assert ((dirs["port"] / n).read_bytes()
                == (dirs["ref"] / n).read_bytes()), n


# ---------------------------------------------------------------------------
# the factories (GPBasic, GPOpt) and the package roots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factory", ["GPBasic", "GPOpt"])
def test_gp_factories_equal_reference(factory):
    """Each factory's empty GP in both packages: the kernel's and the
    mean's parameters, the buffers' shapes and dtype, and the prior."""
    import limbo_tpu.models as jmodels

    import limbo_tpu_torch.models as tmodels

    j = getattr(jmodels, factory)(3, dim_out=2, capacity=64,
                                  dtype=jnp.float64)
    t = getattr(tmodels, factory)(3, dim_out=2, capacity=64,
                                  dtype=torch.float64, device="cpu")
    assert type(t.kernel).__name__ == type(j.kernel).__name__
    assert type(t.mean).__name__ == type(j.mean).__name__
    _close(t.kernel.params, j.kernel.params)
    assert t.x.shape == j.x.shape and t.y.shape == j.y.shape
    assert t.x.dtype == torch.float64 and t.n == int(j.n) == 0
    Xq = np.random.default_rng(0).uniform(size=(5, 3))
    from limbo_tpu.models import gp as jgp
    from limbo_tpu_torch.models import gp as tgp

    for a, b in zip(tgp.query(t, _t(Xq)),
                    jax.jit(jgp.query)(j, jnp.asarray(Xq))):
        _close(a, b)


def test_package_roots_export_the_references_names():
    import limbo_tpu.models as jmodels
    import limbo_tpu.ops as jops

    import limbo_tpu_torch.models as tmodels
    import limbo_tpu_torch.ops as tops
    import limbo_tpu_torch.opt as topt

    assert set(jops.__all__) <= set(tops.__all__)
    for name in ("GPBasic", "GPOpt", "KernelLFOpt", "KernelLooOpt",
                 "KernelMeanLFOpt", "MeanLFOpt", "NoLFOpt"):
        assert hasattr(jmodels, name) and hasattr(tmodels, name)
    assert "Nsga2" in topt.__all__


def test_mo_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the slice's entry points called without
    device='cpu' raise instead of running on the CPU."""
    import limbo_tpu_torch.models as tmodels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Ehvi(ref=(0.0, 0.0)), lambda: Nsbo(n_objs=2),
                 lambda: Parego(n_objs=2), lambda: BoMulti(n_objs=2),
                 lambda: tmodels.GPBasic(2), lambda: tmodels.GPOpt(2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
