"""The port's distribution layer over 2 ranks (gloo, CPU), against the JAX
package.

Two processes (tests/torch_dist_worker.py) join one group through
``multihost.initialize`` (a TCP loopback on localhost) and run every 2-rank
check once; each writes its results, its own row blocks and column panels
included, and this file holds them against the JAX package on the same
numpy data: its sharded fit on a 2-device mesh (the one JAX sharded call),
and its single-device deferred cache for the cached query, the cache
built from the sharded factor, the appends and DistributedBOptimizer.

Tolerances: in f64, 1e-9 of the largest entry of the compared array (the
two libraries sum products and solves in other orders; the rounding is
~1e-14 of it); the f32 run with a bf16 mirror to kappa(K) 2^-23 of the
largest entry (one bf16 step for the mirror), as its test says.
Proposals must be the same bits on both ranks.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from limbo_tpu.kernels import MaternFiveHalves, SquaredExpARD
from limbo_tpu.means import DataMean
from limbo_tpu.models import gp as jgp
from limbo_tpu.parallel.mesh import make_mesh
from limbo_tpu.parallel.sharded_chol import sharded_fit as jsharded_fit

import torch_dist_worker as w

F64 = jnp.float64
WORLD = 2
REL = 1e-9
_jadd = jax.jit(jgp.add_sample_cached, static_argnames=("fast_update",))
# the reference's fit and cache build as jitted programs: one compile each
# in place of one per operation (the same functions)
_jfit = jax.jit(jgp.fit, static_argnames=("capacity",))
_jbuild = jax.jit(jgp.QueryCache.build,
                  static_argnames=("with_Linv", "qdtype", "defer_m"))


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * max(float(np.abs(want).max()), 1.0),
                               rtol=0)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (one 2-process run for the whole file)."""
    out = tmp_path_factory.mktemp("ranks")
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(Path(w.__file__)), str(r), str(WORLD), port,
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        logs.append(log)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in log, log[-3000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _rows(ranks, key):
    """A row-split array assembled from the ranks' blocks."""
    return np.concatenate([r[key] for r in ranks], axis=0)


def _cols(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


def _j(a):
    return jnp.asarray(np.asarray(a), F64)


def _jkernel_mean():
    return (SquaredExpARD.create(dim=w.D, dtype=F64),
            DataMean.create(dim_out=1, dtype=F64))


def test_sharded_fit_matches_jax_mesh(ranks):
    """sharded_fit over 2 ranks at N = 64, block 16 against the JAX
    package's sharded_fit on a 2-device mesh: the factor (each rank's row
    block), alpha, logdet and LML; sharded_query against the dense GP's
    posterior; the fit's psum payload against the closed form of
    tests/test_comm_audit.py (f64 words)."""
    X, Y = w.data(0, w.N_CAP)
    kern, mean = _jkernel_mean()
    ref = jsharded_fit(make_mesh(WORLD, axis_name="rows"), kern, mean,
                       _j(X), _j(Y), block=w.BLOCK)
    _close(_rows(ranks, "a_L"), ref.L)
    for r in ranks:
        _close(r["a_alpha"], ref.alpha)
        _close(r["a_logdet"], ref.logdet)
        _close(r["a_lml"], ref.lml)
    dense = _jfit(kern, mean, _j(X), _j(Y), capacity=w.N_CAP)
    mu, var = jgp.query(dense, _j(w.data(1, 16)[0]))
    for r in ranks:
        _close(r["a_mu"], mu)
        _close(r["a_var"], var)
    N, B, p, nb = w.N_CAP, w.BLOCK, 1, w.N_CAP // w.BLOCK
    words = B * B * nb * (nb - 1) // 2 + nb * B * B + 2 * nb * B * p + 1
    assert ranks[0]["a_fit_bytes"].tolist() == [8 * words, 0]


def test_sharded_query_cached_and_gradient(ranks):
    """The column-split cached query and its symmetric-VJP gradient over 2
    ranks against the JAX single-device deferred cache (f64), with one
    psum of q numbers forward and one all_gather of q N backward."""
    Xb, Yb = w.data(2, 48)
    Xq = _j(w.data(1, 16)[0])
    gp = _jfit(*_jkernel_mean(), _j(Xb), _j(Yb), capacity=w.N_CAP)
    cache = _jbuild(gp, with_Linv=True, defer_m=8)
    mu, var = jgp.query_cached(gp, cache, Xq)
    g = jax.grad(lambda x: jgp.query_cached(gp, cache, x[None, :])[1][0])(
        Xq[0])
    for r in ranks:
        _close(r["b_mu"], mu)
        _close(r["b_var"], var)
        _close(r["b_grad"], g)
        assert r["b_query_bytes"].tolist() == [8, 8 * w.N_CAP]


def test_sharded_bo_iter_tracks_jax_deferred(ranks):
    """make_sharded_bo_iter over 2 ranks in f32 with a bf16 mirror, 6
    iterations across a defer_m = 4 flush: its proposals replayed through
    the JAX single-device add_sample_cached(fast_update="deferred") from
    the same f32 fit.  The assembled K^-1 panels, L, Linv, alpha, ay and
    u_ones are held to it within kappa(K) 2^-23 of the larger of 1 and
    each array's largest entry (the first-order f32 error of a solve with
    K, kappa(K) the f64 condition number of the final training covariance,
    ~3.8e3 here), the bf16 mirror panels within one bf16 step (2^-7) of
    the largest entry.
    Also held to the port's own single-device deferred appends of the
    same proposals, whose code it shares (the panel flush aside), to 1e-6
    of the largest K^-1 entry, and ay to 1e-4."""
    Xb, Yb = w.data(2, 48)
    r0 = ranks[0]
    X = np.concatenate([Xb, r0["bi_x"]])
    Y = np.concatenate([Yb, r0["bi_y"]])
    L64 = np.asarray(_jfit(*_jkernel_mean(), _j(X), _j(Y),
                             capacity=w.N_CAP).L)[:len(X), :len(X)]
    ev = np.linalg.eigvalsh(L64 @ L64.T)
    rel = ev[-1] / ev[0] * 2.0 ** -23
    f32 = jnp.float32
    kern = SquaredExpARD.create(dim=w.D, dtype=f32)
    mean = DataMean.create(dim_out=1, dtype=f32)
    gp = _jfit(kern, mean, jnp.asarray(Xb, f32), jnp.asarray(Yb, f32),
                 capacity=w.N_CAP)
    cache = _jbuild(gp, with_Linv=True, qdtype=jnp.bfloat16,
                                 defer_m=4)
    for x, y in zip(r0["bi_x"], r0["bi_y"]):
        gp, cache = _jadd(gp, cache, jnp.asarray(x, f32),
                          jnp.asarray(y, f32), fast_update="deferred")
    assert r0["bi_n"] == int(gp.n) == 54
    assert r0["bi_base_n"] == int(cache.base_n) == 52
    _close(_cols(ranks, "bi_Kinv"), cache.Kinv, rel)
    _close(_cols(ranks, "bi_Kinv_q"), cache.Kinv_q.astype(f32), 2.0 ** -7)
    for r in ranks:
        for key, want in (("bi_L", gp.L), ("bi_Linv", cache.Linv),
                          ("bi_alpha", gp.alpha), ("bi_ay", cache.ay),
                          ("bi_u_ones", cache.u_ones)):
            _close(r[key], want, rel)
        assert r["bi_kinv_err"] <= 1e-6 * r["bi_kinv_scale"]
        assert r["bi_ay_err"] <= 1e-4


def test_big_cache_and_append_with_flush(ranks):
    """sharded_cache_from_fit over 2 ranks (the assembled K^-1 panels, ay,
    alpha) and 5 distributed appends with defer_m = 4, one flush, against
    the JAX single-device cache and add_sample_cached(fast_update=
    "deferred") on the same points (f64); the build's and each append's
    psum payloads against the closed forms (D = 2: 2 N^2 + 2 N (p + 1);
    2 N + B^2, plus N (p + 1) at the flush)."""
    Xc, Yc = w.data(3, 40)
    gp = _jfit(*_jkernel_mean(), _j(Xc), _j(Yc), capacity=w.N_CAP)
    cache = _jbuild(gp, with_Linv=True, defer_m=4)
    _close(_cols(ranks, "c_Kq0"), cache.Kinv)
    for r in ranks:
        _close(r["c_ay0"], cache.ay)
        _close(r["c_alpha0"], gp.alpha)
    for x in w.data(4, 5)[0]:
        gp, cache = _jadd(gp, cache, _j(x), _j([w.f_host(x)]),
                          fast_update="deferred")
    assert ranks[0]["c_n"] == int(gp.n) == 45
    assert ranks[0]["c_base_n"] == int(cache.base_n) == 44
    _close(_rows(ranks, "c_L"), gp.L)
    _close(_cols(ranks, "c_Kq"), cache.Kinv)
    for r in ranks:
        _close(r["c_alpha"], gp.alpha)
        _close(r["c_ay"], cache.ay)
        _close(r["c_u_ones"], cache.u_ones)
    N, B, p = w.N_CAP, w.BLOCK, 1
    assert ranks[0]["c_build_bytes"].tolist() == [
        8 * (2 * N * N + 2 * N * (p + 1)), 0]
    add = 2 * N + B * B
    assert ranks[0]["c_add_bytes"][:, 0].tolist() == [
        8 * add] * 3 + [8 * (add + N * (p + 1)), 8 * add]


def test_distributed_bo_tracks_single_device(ranks):
    """DistributedBOptimizer over 2 ranks (f64, block 16, defer_m = 4):
    every proposal fed to the JAX single-device deferred cache, the split
    state (assembled factor, alpha) tracks it across the flush, and the
    best value is the largest observation (the reference's own assertion,
    tests/test_distributed_bo.py:74, holds whatever the values)."""
    r0 = ranks[0]
    assert r0["d_iter"] == 6 and r0["d_n"] == 26 and r0["d_cap"] == 32
    gp = _jfit(MaternFiveHalves.create(dtype=F64),
                 DataMean.create(dim_out=1, dtype=F64), _j(r0["d_X0"]),
                 _j(r0["d_Y0"][:, None]), capacity=int(r0["d_cap"]))
    cache = _jbuild(gp, with_Linv=True, defer_m=4)
    for x, y in zip(r0["d_xs"], r0["d_ys"]):
        gp, cache = _jadd(gp, cache, _j(x), _j([y]), fast_update="deferred")
    assert int(gp.n) == 26
    _close(_rows(ranks, "d_L"), gp.L)
    for r in ranks:
        _close(r["d_alpha"], gp.alpha)
        observed = np.concatenate([r["d_Y0"], r["d_ys"]])
        assert r["d_best"] == observed.max()


def test_proposals_bit_equal_across_ranks(ranks):
    """The replicated ascent gives both ranks the same bits: the proposals
    of DistributedBOptimizer, make_sharded_bo_iter and the dry run; and
    CMA-ES / NSGA-II with the population split over the ranks give the
    bits of the same draws unsplit."""
    a, b = ranks
    for k in ("d_xs", "bi_x", "e_restart_x", "e_cols_x", "e_big_x",
              "e_mu_q", "e_sharded_mu", "e_cmaes_split_x",
              "e_nsga2_split_X"):
        assert a[k].tobytes() == b[k].tobytes(), k
    for r in ranks:
        for opt, k in (("cmaes", "x"), ("cmaes", "v"), ("nsga2", "X"),
                       ("nsga2", "Y")):
            assert (r[f"e_{opt}_split_{k}"].tobytes()
                    == r[f"e_{opt}_whole_{k}"].tobytes()), (opt, k)


def test_multihost_initialize_loopback(ranks):
    """multihost.initialize over a TCP loopback: both ranks in one group
    of 2, the restart fan-out's global argmax finds the target, and a psum
    over both axes of the (hosts, devices) mesh counts every rank."""
    for rank, r in enumerate(ranks):
        assert r["info"].tolist() == [WORLD, rank, WORLD]
        np.testing.assert_allclose(r["f_x"], w.TARGET, atol=1e-2)
        assert r["f_total"].tolist() == [float(WORLD)]
        assert int(np.prod(r["f_hmesh"])) == WORLD
