"""One rank of the 2-rank run of the port's distribution layer
(tests/test_torch_distributed.py).

Run as:  python torch_dist_worker.py <rank> <world> <port> <out_dir>

The rank joins the group through ``multihost.initialize`` (a TCP loopback
on localhost, gloo, CPU tensors), runs every 2-rank check of the layer on
the data of ``data()`` (numpy, seeded, shared with the test, which holds
the results against the JAX package), and writes what it got to
``<out_dir>/rank<rank>.npz``.  It imports torch and the port only.
"""

import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

F64 = torch.float64
CPU = "cpu"
D = 3                 # input dimension of the GP checks
N_CAP, BLOCK = 64, 16
TARGET = (0.3, 0.7)


def data(seed: int, n: int, d: int = D):
    """(X (n, d), Y (n, 1)) in f64: Y = sin(3 sum x) + 0.1 noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    return X, np.sin(3.0 * X.sum(axis=1, keepdims=True)) \
        + 0.1 * rng.normal(size=(n, 1))


def padded(seed: int, n: int):
    X, Y = data(seed, n)
    Xp, Yp = np.zeros((N_CAP, D)), np.zeros((N_CAP, 1))
    Xp[:n], Yp[:n] = X, Y
    return Xp, Yp


def f_host(x):
    return np.sin(3.0 * float(np.sum(x)))


def objective(x):
    return torch.sin(3.0 * torch.sum(x))[None]


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _kernel_mean(dtype=F64):
    from limbo_tpu_torch.kernels import SquaredExpARD
    from limbo_tpu_torch.means import DataMean

    return (SquaredExpARD.create(dim=D, device=CPU, dtype=dtype),
            DataMean.create(dim_out=1, device=CPU, dtype=dtype))


def _bytes(stats):
    return [stats.get(k, {}).get("bytes", 0) for k in ("psum", "all_gather")]


def run(rank: int, world: int, port: int) -> dict:
    from limbo_tpu_torch.acqui import UCB
    from limbo_tpu_torch.models import gp as gp_mod
    from limbo_tpu_torch.opt import Cmaes, Nsga2, RandomRestarts, Rprop
    from limbo_tpu_torch.parallel import multihost
    from limbo_tpu_torch.parallel.comm_audit import collective_volume
    from limbo_tpu_torch.parallel.dryrun import run_dryrun
    from limbo_tpu_torch.parallel.mesh import make_mesh, mesh_axis, psum
    from limbo_tpu_torch.parallel.sharded import sharded_restart_opt
    from limbo_tpu_torch.parallel.sharded_acq import (ShardColsGPView,
                                                      make_sharded_bo_iter,
                                                      shard_cache_cols,
                                                      sharded_query_cached)
    from limbo_tpu_torch.parallel.sharded_big import (_big_add,
                                                      sharded_cache_from_fit)
    from limbo_tpu_torch.parallel.sharded_chol import (sharded_fit,
                                                       sharded_query)

    info = multihost.initialize(coordinator_address=f"localhost:{port}",
                                num_processes=world, process_id=rank,
                                device=CPU)
    out = {"info": np.array([info["num_processes"], info["process_id"],
                             info["global_devices"]])}
    mesh = make_mesh(axis_name="rows")
    kernel, mean = _kernel_mean()
    Xq = _t(data(1, 16)[0])

    # (a) the sharded fit and query at N = 64, block 16 (f64)
    Xp, Yp = data(0, N_CAP)
    got = []
    stats = collective_volume(lambda: got.append(sharded_fit(
        mesh, kernel, mean, _t(Xp), _t(Yp), block=BLOCK, axis="rows")))
    sgp = got[0]
    mu, var = sharded_query(mesh, sgp, Xq)
    out.update(a_L=sgp.L.numpy(), a_alpha=sgp.alpha.numpy(),
               a_logdet=sgp.logdet.numpy(), a_lml=sgp.lml.numpy(),
               a_fit_bytes=_bytes(stats), a_mu=mu.numpy(), a_var=var.numpy())

    # (b) the column-sharded cached query and its gradient (f64, deferred
    # cache with 8 pending slots), from the port's single-device cache
    Xb, Yb = data(2, 48)
    gp = gp_mod.fit(kernel, mean, _t(Xb), _t(Yb), capacity=N_CAP,
                    device=CPU)
    cache = gp_mod.QueryCache.build(gp, with_Linv=True, defer_m=8)
    mesh_c = make_mesh(axis_name="cols")
    view = ShardColsGPView(gp=gp, cache=shard_cache_cols(mesh_c, cache),
                           axis=mesh_axis(mesh_c))
    mu, var = sharded_query_cached(view, Xq)
    x0 = Xq[0].clone().requires_grad_(True)
    grads = []

    def value_and_grad():
        v = sharded_query_cached(view, x0[None, :])[1][0]
        grads.append(torch.autograd.grad(v, x0)[0])

    stats = collective_volume(value_and_grad)
    out.update(b_mu=mu.numpy(), b_var=var.numpy(), b_grad=grads[0].numpy(),
               b_query_bytes=_bytes(stats))

    # (b') make_sharded_bo_iter in f32 with a bf16 mirror, 6 iterations
    # across a defer_m = 4 flush; the same proposals through the port's
    # single-device deferred appends give the reference panel
    k32, m32 = _kernel_mean(torch.float32)
    gp = gp_mod.fit(k32, m32, _t(Xb, torch.float32), _t(Yb, torch.float32),
                    capacity=N_CAP, device=CPU)
    cache = gp_mod.QueryCache.build(gp, with_Linv=True,
                                    qdtype=torch.bfloat16, defer_m=4)
    gp_r = gp_mod.fit(k32, m32, _t(Xb, torch.float32),
                      _t(Yb, torch.float32), capacity=N_CAP, device=CPU)
    cache_r = gp_mod.QueryCache.build(gp_r, with_Linv=True,
                                      qdtype=torch.bfloat16, defer_m=4)
    cache = shard_cache_cols(mesh_c, cache)
    opt = RandomRestarts(sub=Rprop(iterations=10), repeats=4,
                         sweep_samples=32)
    step = make_sharded_bo_iter(mesh_c, objective, UCB(alpha=0.5), opt)
    gen = torch.Generator().manual_seed(7)
    xs, ys = [], []
    for it in range(6):
        gp, cache, x, y = step(gp, cache, gen, it)
        xs.append(x.clone()), ys.append(y.clone())
        gp_r, cache_r = gp_mod.add_sample_cached(gp_r, cache_r, x, y,
                                                 fast_update="deferred")
    nloc = N_CAP // world
    ref = cache_r.Kinv[:, rank * nloc:(rank + 1) * nloc]
    out.update(bi_x=torch.stack(xs).numpy(), bi_y=torch.stack(ys).numpy(),
               bi_Kinv=cache.Kinv.numpy(),
               bi_Kinv_q=cache.Kinv_q.float().numpy(),
               bi_Linv=cache.Linv.numpy(), bi_L=gp.L.numpy(),
               bi_alpha=gp.alpha.numpy(), bi_ay=cache.ay.numpy(),
               bi_u_ones=cache.u_ones.numpy(), bi_n=gp.n,
               bi_base_n=cache.base_n,
               bi_kinv_err=float((cache.Kinv - ref).abs().max()),
               bi_kinv_scale=float(ref.abs().max()),
               bi_ay_err=float((cache.ay - cache_r.ay).abs().max()))

    # (c) the beyond-one-card path: K^-1 panels from the sharded factor,
    # then 5 appends with defer_m = 4 (a flush at the 4th), in f64
    Xc, Yc = padded(3, 40)
    sgp = sharded_fit(mesh, kernel, mean, _t(Xc), _t(Yc), n=40, block=BLOCK,
                      axis="rows")
    got = []
    stats = collective_volume(lambda: got.append(sharded_cache_from_fit(
        mesh, sgp, defer_m=4)))
    big = got[0]
    out.update(c_Kq0=big.Kq.numpy().copy(), c_ay0=big.ay.numpy(),
               c_alpha0=big.alpha.numpy(), c_build_bytes=_bytes(stats))
    Xn = data(4, 5)[0]
    add_bytes = []
    for x in Xn:
        got = []
        stats = collective_volume(lambda: got.append(_big_add(
            big, _t(x), _t([f_host(x)]), big.axis)))
        big = got[0]
        add_bytes.append(_bytes(stats))
    out.update(c_add_bytes=np.array(add_bytes), c_L=big.L.numpy(),
               c_Kq=big.Kq.numpy(), c_alpha=big.alpha.numpy(),
               c_ay=big.ay.numpy(), c_u_ones=big.u_ones.numpy(),
               c_L11invs=big.L11invs.numpy(), c_n=big.n,
               c_base_n=big.base_n)

    # (d) DistributedBOptimizer: ask/tell, 20 init points, 6 iterations
    from limbo_tpu_torch.bo import DistributedBOptimizer, MaxIterations
    from limbo_tpu_torch.bo.init_designs import RandomSampling
    from limbo_tpu_torch.kernels import MaternFiveHalves
    from limbo_tpu_torch.means import DataMean

    dbo = DistributedBOptimizer(
        mesh, kernel=MaternFiveHalves.create(device=CPU, dtype=F64),
        mean=DataMean.create(dim_out=1, device=CPU, dtype=F64),
        acqui=UCB(alpha=0.5),
        acqui_optimizer=RandomRestarts(sub=Rprop(iterations=8), repeats=3,
                                       sweep_samples=16),
        init=RandomSampling(20), stop=(MaxIterations(6),),
        stats_enabled=False, block=BLOCK, defer_m=4, dtype=F64)
    state = dbo.init_state(2, generator=torch.Generator().manual_seed(0))
    X0, Y0, xs, ys = [], [], [], []
    while state.pending_init:
        x = dbo.ask(state)
        X0.append(x), Y0.append(f_host(x))
        dbo.tell(state, x, Y0[-1])
    while not dbo._stopped(state):
        x = dbo.ask(state)
        xs.append(x), ys.append(f_host(x))
        dbo.tell(state, x, ys[-1])
    out.update(d_X0=np.stack(X0), d_Y0=np.array(Y0), d_xs=np.stack(xs),
               d_ys=np.array(ys), d_L=state.gp.L.numpy(),
               d_alpha=state.gp.alpha.numpy(), d_n=state.gp.n,
               d_cap=state.gp.capacity, d_best=state.best_value,
               d_iter=state.iteration)

    # (e) the dry run over both ranks, and CMA-ES / NSGA-II with the
    # population split over the mesh against the same draws unsplit
    dry = run_dryrun()
    out.update({f"e_{k}": v.detach().numpy() for k, v in dry.items()})
    t = _t(TARGET + (0.5,), torch.float32)

    def fun(Z):
        return -torch.sum((Z - t) ** 2, dim=1)

    z = torch.randn((1, 10, 6, D), generator=torch.Generator().manual_seed(3))
    init = torch.full((D,), 0.5)
    for name, opt in (("split", Cmaes(iterations=10, pop_size=6, mesh=mesh)),
                      ("whole", Cmaes(iterations=10, pop_size=6))):
        r = opt.from_draws(fun, init, z)
        out.update({f"e_cmaes_{name}_x": r.x.numpy(),
                    f"e_cmaes_{name}_v": r.value.numpy()})

    def fun2(Z):
        return torch.stack([-torch.sum(Z ** 2, dim=1),
                            -torch.sum((Z - 1.0) ** 2, dim=1)], dim=1)

    for name, opt in (("split", Nsga2(pop_size=10, generations=5,
                                      mesh=mesh)),
                      ("whole", Nsga2(pop_size=10, generations=5))):
        Xn2, Yn2 = opt(fun2, D, torch.Generator().manual_seed(5))
        out.update({f"e_nsga2_{name}_X": Xn2.numpy(),
                    f"e_nsga2_{name}_Y": Yn2.numpy()})

    # (f) the multihost meshes: restarts over every rank with a global
    # argmax, and a psum over both axes of the (hosts, devices) mesh
    gmesh = multihost.global_mesh(axis_name="restarts")
    res = sharded_restart_opt(gmesh, Rprop(iterations=60),
                              lambda Z: -torch.sum((Z - t[:2]) ** 2, dim=1),
                              torch.full((2,), 0.5),
                              torch.Generator().manual_seed(0), True,
                              restarts_per_device=2)
    hmesh = multihost.host_data_mesh()
    one = torch.ones(1)
    total = psum(psum(one, mesh_axis(hmesh, "hosts")),
                 mesh_axis(hmesh, "devices"))
    out.update(f_x=res.x.numpy(), f_total=total.numpy(),
               f_hmesh=np.array(hmesh.shape))
    multihost.shutdown()
    return out


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    out = run(rank, world, port)
    np.savez(Path(sys.argv[4]) / f"rank{rank}.npz",
             **{k: np.asarray(v) for k, v in out.items()})
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
