"""The port's distribution layer at world size 1 (one process, a gloo
group from a FileStore), against the JAX package's single-device
functions, as the JAX package's own sharded tests compare (those run on
its 8-device mesh and are marked slow).  tests/test_torch_distributed.py
holds the same layer over 2 ranks.

Each test starts the default process group in a fixture and destroys it,
so no group outlives a test.  Tolerances: in f64, 1e-9 of the largest
entry of the compared array (the two libraries sum in other orders); the
CG solve to 1e-7 of alpha's largest entry (its relative residual limit is
1e-10, at the kernel matrix's conditioning here); the collective audit's
payloads exactly, to the closed forms of tests/test_comm_audit.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limbo_tpu.kernels import SquaredExpARD as JSquaredExpARD
from limbo_tpu.means import DataMean as JDataMean
from limbo_tpu.models import gp as jgp
from limbo_tpu.ops.chol import cholesky as jcholesky
from limbo_tpu_torch import kernels, means
from limbo_tpu_torch.acqui import UCB
from limbo_tpu_torch.means.means import prepare_mean
from limbo_tpu_torch.opt import Cmaes, Nsga2, RandomRestarts, Rprop
from limbo_tpu_torch.parallel import comm_audit, mesh as pmesh, multihost
from limbo_tpu_torch.parallel.comm_audit import collective_volume

torch.set_num_threads(1)

F64 = torch.float64
REL = 1e-9
# the reference's fit as one jitted program: one compile in place of one
# per operation (the same function)
_jfit = jax.jit(jgp.fit, static_argnames=("capacity",))


@pytest.fixture
def group():
    with pmesh.start_group(device="cpu") as g:
        yield g


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * max(float(np.abs(want).max()), 1.0),
                               rtol=0)


def _data(seed, n, d=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    return X, np.sin(3.0 * X.sum(axis=1, keepdims=True)) \
        + 0.1 * rng.normal(size=(n, 1))


def _pad(X, Y, N):
    Xp, Yp = np.zeros((N, X.shape[1])), np.zeros((N, Y.shape[1]))
    Xp[:len(X)], Yp[:len(Y)] = X, Y
    return torch.as_tensor(Xp), torch.as_tensor(Yp)


def _port(dtype=F64, d=3, p=1):
    return (kernels.SquaredExpARD.create(dim=d, device="cpu", dtype=dtype),
            means.DataMean.create(dim_out=p, device="cpu", dtype=dtype))


def _jax(d=3, p=1):
    return (JSquaredExpARD.create(dim=d, dtype=jnp.float64),
            JDataMean.create(dim_out=p, dtype=jnp.float64))


def test_sharded_fit_query_match_dense(group):
    """sharded_cholesky, sharded_fit (padded: n = 50 of N = 64) and
    sharded_query against limbo_tpu's dense cholesky, gp.fit, its LML and
    gp.query (f64, block 16)."""
    from limbo_tpu_torch.parallel.sharded_chol import (sharded_cholesky,
                                                       sharded_fit,
                                                       sharded_query)

    mesh = pmesh.make_mesh(axis_name="rows")
    rng = np.random.default_rng(0)
    M = rng.normal(size=(64, 64))
    A = M @ M.T / 64 + 0.5 * np.eye(64)
    _close(sharded_cholesky(mesh, torch.as_tensor(A), block=16),
           jcholesky(jnp.asarray(A)))
    with pytest.raises(ValueError, match="multiple of"):
        sharded_cholesky(mesh, torch.as_tensor(A[:60, :60]), block=16)
    X, Y = _data(1, 50)
    Xp, Yp = _pad(X, Y, 64)
    sgp = sharded_fit(mesh, *_port(), Xp, Yp, n=50, block=16)
    kern, mean = _jax()
    ref = _jfit(kern, mean, jnp.asarray(X), jnp.asarray(Y), capacity=64)
    _close(sgp.L, ref.L)
    _close(sgp.alpha, ref.alpha)
    _close(sgp.lml, jgp.log_marginal_likelihood(kern, mean, ref.x, ref.y,
                                                ref.n))
    Xq = _data(2, 16)[0]
    mu, var = sharded_query(mesh, sgp, torch.as_tensor(Xq))
    mu_r, var_r = jgp.query(ref, jnp.asarray(Xq))
    _close(mu, mu_r)
    _close(var, var_r)


@pytest.mark.parametrize("N,B,p", [(64, 8, 1), (128, 16, 2)])
def test_comm_audit_closed_forms(group, N, B, p):
    """The audited per-rank payloads (f32 words) of the sharded fit, the
    cache build from it, an append without and with a flush (an f32 panel:
    N (p + 1) more; a bf16 panel: a rebuild, 2 N^2 + 2 N (p + 1) more) and
    one acquisition step (psum q forward, all_gather q N backward) equal
    the closed forms of tests/test_comm_audit.py at D = 1."""
    from limbo_tpu_torch.parallel.sharded_big import (_big_add, big_query,
                                                      sharded_cache_from_fit)
    from limbo_tpu_torch.parallel.sharded_chol import sharded_fit

    mesh = pmesh.make_mesh(axis_name="rows")
    X, Y = _data(3, N - 4, d=3)
    Y = np.repeat(Y, p, axis=1)
    Xp, Yp = _pad(X, Y, N)
    Xp, Yp = Xp.float(), Yp.float()
    kern, mean = _port(torch.float32, p=p)
    word = 4
    got = []

    def psum_bytes(fn):
        stats = collective_volume(lambda: got.append(fn()))
        assert set(stats) <= {"psum"}
        return stats.get("psum", {"bytes": 0})["bytes"] // word

    nb = N // B
    assert psum_bytes(lambda: sharded_fit(mesh, kern, mean, Xp, Yp, n=N - 4,
                                          block=B)) == (
        B * B * nb * (nb - 1) // 2 + nb * B * B + 2 * nb * B * p + 1)
    sgp = got[-1]
    assert psum_bytes(lambda: sharded_cache_from_fit(mesh, sgp,
                                                     defer_m=2)) == (
        2 * N * N + 2 * N * (p + 1))
    big = got[-1]
    bf = sharded_cache_from_fit(mesh, sgp, qdtype=torch.bfloat16, defer_m=1)
    x = torch.full((3,), 0.5)
    y = torch.zeros((p,))
    add = 2 * N + B * B
    assert psum_bytes(lambda: _big_add(big, x, y, big.axis)) == add
    assert psum_bytes(lambda: _big_add(got[-1], x + 0.1, y,
                                       big.axis)) == add + N * (p + 1)
    assert psum_bytes(lambda: _big_add(bf, x, y, bf.axis)) == (
        add + 2 * N * N + 2 * N * (p + 1))
    Xq = torch.rand((5, 3), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    stats = collective_volume(
        lambda: big_query(got[-2], Xq)[1].sum().backward())
    assert stats == {"psum": {"count": 1, "bytes": 5 * word},
                     "all_gather": {"count": 1, "bytes": 5 * N * word}}


def test_audit_counts_what_runs(group):
    """The run-time audit: each wrapper's payload (psum: its operand;
    all_gather: its gathered output), a loop as often as it ran, only the
    branch taken, nested audits each charged, total_bytes."""
    ax = pmesh.mesh_axis(pmesh.make_mesh(axis_name="r"))

    def body(x, heavy):
        s = pmesh.psum(x @ x.T, ax)                      # (8, 8)
        g = pmesh.all_gather(x[0], ax)                   # (16,) at D = 1
        for _ in range(3):
            pmesh.psum(x[:1].clone(), ax)                # (1, 16), 3 times
        if heavy:
            pmesh.psum(x.clone(), ax)                    # (8, 16)
        return s, g

    x = torch.ones((8, 16))
    inner = {}

    def both():
        inner["light"] = collective_volume(body, x, False)
        inner["heavy"] = collective_volume(body, x, True)

    outer = collective_volume(both)
    light, heavy = inner["light"], inner["heavy"]
    assert light == {"psum": {"count": 4, "bytes": 4 * (64 + 3 * 16)},
                     "all_gather": {"count": 1, "bytes": 4 * 16}}
    assert heavy["psum"] == {"count": 5, "bytes": 4 * (64 + 3 * 16 + 128)}
    assert outer["psum"]["count"] == 9
    assert comm_audit.total_bytes(heavy) == 4 * (64 + 48 + 128 + 16)
    t = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(pmesh.all_gather(t, ax, dim=1), t)
    assert pmesh.shard_batch(pmesh.make_mesh(), "restarts")(t) is not None
    with pytest.raises(ValueError, match="group has 1"):
        pmesh.make_mesh(2)


def test_cg_row_mean_and_restarts(group):
    """sharded_cg_fit_alpha against the dense fit's alpha,
    row_sharded_posterior_mean against gp.query's mean (JAX, f64), and
    sharded_restart_opt against the same starts run unsplit."""
    from limbo_tpu_torch.parallel.distributed_gp import sharded_cg_fit_alpha
    from limbo_tpu_torch.parallel.sharded import (row_sharded_posterior_mean,
                                                  sharded_restart_opt)

    mesh = pmesh.make_mesh(axis_name="rows")
    X, Y = _data(4, 56)
    kern, mean = _jax()
    ref = _jfit(kern, mean, jnp.asarray(X), jnp.asarray(Y), capacity=64)
    Xp, Yp = _pad(X, Y, 64)
    k, m = _port()
    mask = (torch.arange(64) < 56).to(F64)
    m = prepare_mean(m, Yp, mask)
    centered = (Yp - m(Xp)) * mask[:, None]
    alpha = sharded_cg_fit_alpha(mesh, k, Xp, mask, centered, tol=1e-10,
                                 maxiter=200)
    _close(alpha, ref.alpha, rel=1e-7)
    Xq = _data(5, 16)[0]
    mu = row_sharded_posterior_mean(mesh, k, Xp * mask[:, None],
                                    torch.as_tensor(np.array(ref.alpha)),
                                    m(torch.as_tensor(Xq)),
                                    torch.as_tensor(Xq))
    _close(mu, jgp.query(ref, jnp.asarray(Xq))[0])

    def fun(Z):
        return -torch.sum((Z - 0.3) ** 2, dim=1)

    init = torch.full((3,), 0.5)
    res = sharded_restart_opt(mesh, Rprop(iterations=30), fun, init,
                              torch.Generator().manual_seed(1), True,
                              axis="rows")
    starts = torch.rand((4, 3), generator=torch.Generator().manual_seed(1))
    starts[0] = init
    whole = Rprop(iterations=30)(fun, starts, None, True)
    i = torch.argmax(whole.value)
    assert torch.equal(res.x, whole.x[i]) and torch.equal(res.value,
                                                          whole.value[i])


def test_dryrun_optimizers_and_distributed_optimize(group, tmp_path):
    """run_dryrun over the group; Cmaes(mesh=...) and Nsga2(mesh=...)
    against the same draws unsplit (the same bits); DistributedBOptimizer.
    optimize with a stop criterion and a stats writer (f64, block 16)."""
    from limbo_tpu_torch.bo import DistributedBOptimizer, MaxIterations
    from limbo_tpu_torch.bo.init_designs import RandomSampling
    from limbo_tpu_torch.bo.stats import BestAggregatedObservations
    from limbo_tpu_torch.parallel.dryrun import run_dryrun

    out = run_dryrun()
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    mesh = pmesh.make_mesh(axis_name="pop")

    def fun(Z):
        return -torch.sum((Z - 0.3) ** 2, dim=1)

    z = torch.randn((2, 8, 6, 3), generator=torch.Generator().manual_seed(0))
    init = torch.full((3,), 0.5)
    a = Cmaes(iterations=8, pop_size=6, restarts=2, mesh=mesh).from_draws(
        fun, init, z)
    b = Cmaes(iterations=8, pop_size=6, restarts=2).from_draws(fun, init, z)
    assert torch.equal(a.x, b.x) and torch.equal(a.value, b.value)

    def fun2(Z):
        return torch.stack([-torch.sum(Z ** 2, dim=1),
                            -torch.sum((Z - 1.0) ** 2, dim=1)], dim=1)

    Xa, Ya = Nsga2(pop_size=12, generations=4, mesh=mesh)(
        fun2, 3, torch.Generator().manual_seed(2))
    Xb, Yb = Nsga2(pop_size=12, generations=4)(
        fun2, 3, torch.Generator().manual_seed(2))
    assert torch.equal(Xa, Xb) and torch.equal(Ya, Yb)

    dbo = DistributedBOptimizer(
        pmesh.make_mesh(axis_name="rows"),
        acqui_optimizer=RandomRestarts(sub=Rprop(iterations=5), repeats=3,
                                       sweep_samples=16),
        acqui=UCB(alpha=0.5), init=RandomSampling(10),
        stop=(MaxIterations(3),), stats=(BestAggregatedObservations(),),
        res_base_dir=str(tmp_path), block=16, defer_m=2, dtype=F64)
    observed = []

    def f(x):
        observed.append(np.sin(3.0 * float(np.sum(x))))
        return observed[-1]

    state = dbo.optimize(f, dim_in=2)
    assert state.iteration == 3 and state.gp.n == 13
    assert state.best_value == max(observed)
    rows = list(tmp_path.glob("*/best_aggregated_observations.dat"))
    assert len(rows) == 1
    assert len(rows[0].read_text().strip().splitlines()) == 3


def test_multihost_helpers(monkeypatch):
    """_first_slurm_node's expansion, and initialize's single-process
    no-op (no coordinator; one SLURM task) that starts no group."""
    assert multihost._first_slurm_node("n[001-004]") == "n001"
    assert multihost._first_slurm_node("a,b") == "a"
    assert multihost._first_slurm_node("node7") == "node7"
    assert multihost._first_slurm_node("gpu[3,5-7],cpu1") == "gpu3"
    for var in ("SLURM_JOB_NODELIST", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    single = {"num_processes": 1, "process_id": 0, "local_devices": 1,
              "global_devices": 1}
    assert multihost.initialize() == single
    monkeypatch.setenv("SLURM_JOB_NODELIST", "n[001-002]")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert multihost.initialize(device="cpu") == single
    assert multihost.initialize(coordinator_address="localhost:1",
                                num_processes=1) == single
    assert not multihost.is_initialized()
    multihost.shutdown()
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize(coordinator_address="localhost:1",
                             device="cpu")
