"""The port's CMA-ES, DIRECT-L and symmetric eigensolver against the JAX
package's, in f64 (tests/conftest.py turns on x64), on the BO suite's own
test functions.

Every draw is the reference's: CMA-ES's z from ``jax.random.split(key,
iterations)`` (vmapped over ``split(key, restarts)`` for restarts), DIRECT's
tie-break uniforms from the key it splits each round.  The reference's
final carry (mean, step size, rectangles) is read by wrapping
``jax.lax.scan`` / ``jax.lax.fori_loop`` for the length of one call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limbo_tpu.benchmarks import functions as jfun
from limbo_tpu.opt.cmaes import Cmaes as JCmaes
from limbo_tpu.opt.cmaes import reflect01 as jreflect01
from limbo_tpu.opt.direct import DirectL as JDirectL
from limbo_tpu_torch.benchmarks import functions as tfun
from limbo_tpu_torch.opt import Cmaes, DirectL, reflect01
from limbo_tpu_torch.ops.sym_eig import sym_eig, sym_eig_plain

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
# f64 on both sides; the eigensolvers (Jacobi here, LAPACK there) and the
# small products round in other orders, and the rankings repeat unless two
# population values lie within ~1e-15 of each other
CMA_RTOL = 1e-9


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _grab(monkeypatch, name):
    """Wrap jax.lax.<name> so that each call's arguments and result are
    kept."""
    out = []
    orig = getattr(jax.lax, name)

    def wrapped(*args, **kwargs):
        res = orig(*args, **kwargs)
        out.append((args, res))
        return res

    monkeypatch.setattr(jax.lax, name, wrapped)
    return out


def _objectives(fn):
    """(reference, port) maximization objectives of a BO test function:
    (d,) -> scalar and (R, d) -> (R,)."""
    tf = tfun.ALL_FUNCTIONS[[f.name for f in jfun.ALL_FUNCTIONS].index(
        fn.name)].make(torch.device("cpu"), torch.float64)
    return (lambda x: -fn.fn(x)), (lambda X: -tf(X))


def test_sym_eig_plain_matches_lapack():
    """The plain Jacobi solver against numpy's LAPACK eigh on ragged sizes:
    eigenvalues, reconstruction, orthogonality, and the sign rule."""
    rng = np.random.default_rng(0)
    for d, b in ((1, 3), (2, 5), (3, 1), (6, 4), (8, 2)):
        M = rng.standard_normal((b, d, d))
        A = M + M.transpose(0, 2, 1)
        w, V = sym_eig_plain(_t(A))
        w0, V0 = np.linalg.eigh(A)
        np.testing.assert_allclose(w.numpy(), w0, rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            (V @ torch.diag_embed(w) @ V.transpose(-1, -2)).numpy(), A,
            rtol=0, atol=1e-12)
        np.testing.assert_allclose((V.transpose(-1, -2) @ V).numpy(),
                                   np.broadcast_to(np.eye(d), (b, d, d)),
                                   rtol=0, atol=1e-13)
        np.testing.assert_allclose(np.abs(V.numpy()), np.abs(V0), atol=1e-12)
        im = np.argmax(np.abs(V.numpy()), axis=1)
        assert (np.take_along_axis(V.numpy(), im[:, None, :], 1) > 0).all()
    # on the CPU the wrapper is the plain version
    A = _t(A)
    for got, want in zip(sym_eig(A), sym_eig_plain(A)):
        assert torch.equal(got, want)


def test_reflect01():
    x = np.linspace(-3.3, 4.1, 97)
    np.testing.assert_allclose(reflect01(_t(x)).numpy(),
                               np.asarray(jreflect01(jnp.asarray(x))),
                               rtol=0, atol=1e-15)


def _record_eigh(monkeypatch):
    """Wrap jnp.linalg.eigh so that the eigenvectors each call returns are
    kept, in order, also from inside the reference's compiled scan (a
    debug callback); a list that fills as the reference runs."""
    out = []
    orig = jnp.linalg.eigh

    def wrapped(C, *args, **kwargs):
        res = orig(C, *args, **kwargs)
        jax.debug.callback(lambda B: out.append(np.array(B)), res[1])
        return res

    monkeypatch.setattr(jnp.linalg, "eigh", wrapped)
    return out


def _drive(cm, fun, init, z_ref, B_ref):
    """Run the port's generations from the reference's draws z_ref
    (R, iters, lam, d).  The population is y = (z D) B^T, and eigenvectors
    are unique only up to sign, or up to a rotation within an eigenvalue of
    multiplicity > 1 (C = a I plus an update of rank mu < d, as at d = 6
    with mu = 4, where rounding in C, or the solver's code path, turns the
    basis).  So the port is handed z_ref Q, Q = B_ref^T B_port, with B_ref
    (R, iters, d, d) the reference's own eigenvectors at each generation:
    the two then sample the same population.  Where the eigenvalues are
    distinct, Q is diagonal and flips the z columns whose eigenvectors have
    opposite signs.  Returns the port's state and how many generations
    needed more than the identity."""
    state = cm.init_state(init, z_ref.shape[0], True)
    moved = 0
    for t in range(z_ref.shape[1]):
        _, B = sym_eig(state.C)
        Q = _t(B_ref[:, t]).transpose(-1, -2) @ B              # (R, d, d)
        eye = torch.eye(Q.shape[-1], **F64)
        np.testing.assert_allclose((Q.transpose(-1, -2) @ Q).numpy(),
                                   eye.expand_as(Q).numpy(), atol=1e-12)
        moved += int(not torch.allclose(Q, eye, atol=1e-12))
        state = cm.generation(fun, state, _t(z_ref[:, t]) @ Q)
    return state, moved


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=CMA_RTOL, atol=CMA_RTOL)


def test_cmaes_matches_reference(monkeypatch):
    """d = 2 (BraninNormalized), lambda = 8, 10 generations, one restart:
    the mean, step size, best x and best value after the last generation."""
    iters, lam = 10, 8
    jf, tf = _objectives(jfun.BRANIN)
    key = jax.random.PRNGKey(3)
    init = np.array([0.3, 0.7])
    scans = _grab(monkeypatch, "scan")
    B_ref = _record_eigh(monkeypatch)
    ref = JCmaes(iterations=iters, pop_size=lam)(jf, jnp.asarray(init), key)
    final = scans[-1][1][0]
    z = np.stack([np.asarray(jax.random.normal(k, (lam, 2), jnp.float64))
                  for k in jax.random.split(key, iters)])[None]
    cm = Cmaes(iterations=iters, pop_size=lam)
    state, _ = _drive(cm, tf, _t(init), z, np.stack(B_ref)[None])
    _close(state.m[0], final[0])
    _close(state.sigma[0], final[1])
    _close(state.best_x[0], ref.x)
    _close(state.best_v[0], ref.value)


def test_cmaes_restarts_match_reference(monkeypatch):
    """Hartmann6 with 2 restarts (a batch axis in the port, a vmap in the
    reference): each restart's state against the reference's single run
    from its key, split(key, restarts)[r], and the best restart's x and
    value against the reference's restarts=2 call."""
    iters, restarts = 10, 2
    jf, tf = _objectives(jfun.HARTMANN6)
    key = jax.random.PRNGKey(11)
    init = jnp.full((6,), 0.5)
    ref = JCmaes(iterations=iters, restarts=restarts)(jf, init, key)
    cm = Cmaes(iterations=iters, restarts=restarts)
    lam = cm.pop(6)
    rkeys = jax.random.split(key, restarts)
    scans = _grab(monkeypatch, "scan")
    B_ref = _record_eigh(monkeypatch)
    per = [JCmaes(iterations=iters)(jf, init, k) for k in rkeys]
    z = np.stack([np.stack([np.asarray(jax.random.normal(k, (lam, 6),
                                                         jnp.float64))
                            for k in jax.random.split(rk, iters)])
                  for rk in rkeys])
    state, moved = _drive(cm, tf, _t(np.asarray(init)), z,
                          np.stack(B_ref).reshape(restarts, iters, 6, 6))
    assert moved > 0       # the mapping was exercised
    for r in range(restarts):
        final = scans[r][1][0]
        _close(state.m[r], final[0])
        _close(state.sigma[r], final[1])
        _close(state.best_x[r], per[r].x)
        _close(state.best_v[r], per[r].value)
    i = int(torch.argmax(state.best_v))
    _close(state.best_x[i], ref.x)
    _close(state.best_v[i], ref.value)


def test_cmaes_draws_and_mesh():
    """__call__ draws z up front (restarts, iterations, lambda, d) and hands
    them to from_draws; with a mesh (one gloo rank here) the population's
    evaluation is split over it and the result keeps its bits."""
    cm = Cmaes(iterations=3, pop_size=6, restarts=2)
    fun = _objectives(jfun.SPHERE)[1]
    init = torch.full((2,), 0.5, **F64)
    g1 = torch.Generator().manual_seed(4)
    res = cm(fun, init, g1)
    z = torch.randn((2, 3, 6, 2), generator=torch.Generator().manual_seed(4),
                    **F64)
    res2 = cm.from_draws(fun, init, z)
    assert torch.equal(res.x, res2.x) and torch.equal(res.value, res2.value)
    from limbo_tpu_torch.parallel.mesh import make_mesh, start_group

    with start_group(device="cpu"):
        res3 = Cmaes(iterations=3, pop_size=6, restarts=2,
                     mesh=make_mesh()).from_draws(fun, init, z)
    assert torch.equal(res.x, res3.x) and torch.equal(res.value, res3.value)


def _direct_pair(fn, monkeypatch, rounds=8, S=4, seed=5):
    jf, tf = _objectives(fn)
    key = jax.random.PRNGKey(seed)
    init = np.full((fn.dim_in,), 0.5)
    loops = _grab(monkeypatch, "fori_loop")
    ref = JDirectL(rounds=rounds, splits_per_round=S)(jf, jnp.asarray(init),
                                                      key)
    c_ref, side_ref, f_ref, valid_ref, count_ref, _ = loops[-1][1]
    u, k = [], key
    for _ in range(rounds):
        k, kt = jax.random.split(k)
        u.append(np.asarray(jax.random.uniform(kt, (S, fn.dim_in),
                                               jnp.float64)))
    dl = DirectL(rounds=rounds, splits_per_round=S)
    c, side, f, valid, count = dl.rectangles(tf, _t(init), _t(np.stack(u)))
    res = dl.from_draws(tf, _t(init), _t(np.stack(u)))
    return (c_ref, side_ref, f_ref, valid_ref, count_ref, ref), (
        c, side, f, valid, count, res)


@pytest.mark.parametrize("fn", [jfun.BRANIN, jfun.SPHERE],
                         ids=lambda f: f.name)
def test_direct_matches_reference(fn, monkeypatch):
    """8 rounds of 4 splits with the reference's tie draws: the evaluated
    centers in order (exactly), their values, the rectangles, and the best
    value (1e-12).  On Sphere the two children of a split tie exactly, so
    the selection's order among equal scores is what is tested."""
    (c_ref, side_ref, f_ref, valid_ref, count_ref, ref), (
        c, side, f, valid, count, res) = _direct_pair(fn, monkeypatch)
    n = int(count_ref)
    assert int(count) == n and n > 1 + 2 * 4     # several rounds split
    np.testing.assert_array_equal(c[:n].numpy(), np.asarray(c_ref)[:n])
    np.testing.assert_array_equal(side[:n].numpy(), np.asarray(side_ref)[:n])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_ref))
    np.testing.assert_allclose(f[:n].numpy(), np.asarray(f_ref)[:n],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(res.x.numpy(), np.asarray(ref.x))
    np.testing.assert_allclose(float(res.value), float(ref.value),
                               rtol=1e-12, atol=1e-12)


def test_direct_sphere_has_exact_ties(monkeypatch):
    """The Sphere run does meet equal selection scores (else the test above
    would not test the order among ties)."""
    (_, _, f_ref, valid_ref, count_ref, _), _ = _direct_pair(jfun.SPHERE,
                                                             monkeypatch)
    f = np.asarray(f_ref)[:int(count_ref)]
    assert len(np.unique(f)) < len(f)


def test_direct_draws_and_bounds():
    dl = DirectL(rounds=3, splits_per_round=2)
    fun = _objectives(jfun.BRANIN)[1]
    init = torch.full((2,), 0.5, **F64)
    res = dl(fun, init, torch.Generator().manual_seed(9))
    u = torch.rand((3, 2, 2), generator=torch.Generator().manual_seed(9),
                   **F64)
    res2 = dl.from_draws(fun, init, u)
    assert torch.equal(res.x, res2.x) and torch.equal(res.value, res2.value)
    with pytest.raises(ValueError, match="bounded"):
        dl(fun, init, None, bounded=False)
