"""Multi-card dry run: the full training / acquisition step over the
process group's world (port of limbo_tpu/parallel/dryrun.py).

One pass over every path of the distribution layer at a tiny size: a
hyperparameter gradient step on the LML and a refit, the restart fan-out
with its global argmax, the row-sharded posterior mean, a rank-1 append;
then the sharded Cholesky fit and query, one column-sharded cached BO
iteration, one beyond-one-card BO iteration, and on a group of 4 or more
ranks (an even count) the 2-D (restarts x rows) mesh.  Every rank runs it
(the default group must be initialized, parallel/mesh.Group); the sharded
fits use the panel kernel's block, so the same run holds on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from limbo_tpu_torch.acqui.acqui import UCB, FirstElem
from limbo_tpu_torch.kernels import SquaredExpARD
from limbo_tpu_torch.means import DataMean
from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.opt.compose import RandomRestarts
from limbo_tpu_torch.opt.gradient import Rprop
from limbo_tpu_torch.ops.chol import PANEL_BLOCK
from limbo_tpu_torch.parallel.mesh import (all_gather, make_mesh,
                                           make_mesh_2d, mesh_axis,
                                           mesh_device, psum)
from limbo_tpu_torch.parallel.sharded import (row_sharded_posterior_mean,
                                              sharded_restart_opt)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dry run: {what}")


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def run_dryrun(n_devices: int = None) -> dict:
    """Run the dry run on every rank of the default group (n_devices, when
    given, must be its size); returns the checked results."""
    n_dev = n_devices if n_devices is not None else dist.get_world_size()
    mesh = make_mesh(n_dev, axis_name="restarts")
    dev = mesh_device(mesh)
    kw = dict(dtype=torch.float32, device=dev)
    n, d, q = 32, 3, 16
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.rand((n, d), generator=gen, **kw)
    Y = (torch.sin(X.sum(dim=1, keepdim=True))
         + 0.05 * torch.randn((n, 1), generator=gen, **kw))
    Xq = torch.rand((q, d), generator=gen, **kw)
    kernel = SquaredExpARD.create(dim=d, **kw)
    gp = gp_mod.fit(kernel, DataMean.create(dim_out=1, **kw), X, Y,
                    capacity=64 * n_dev, device=dev)
    acqui = UCB(alpha=0.5)

    # (1) a hyperparameter gradient step on the marginal likelihood
    p = gp.kernel.params.clone().requires_grad_(True)
    lml = gp_mod.log_marginal_likelihood(gp.kernel.with_params(p), gp.mean,
                                         gp.x, gp.y, gp.n)
    (g,) = torch.autograd.grad(lml, p)
    gp = gp_mod.recompute(gp.replace(
        kernel=gp.kernel.with_params(p.detach() + 1e-2 * g)))
    # (2) the acquisition fan-out over the mesh and its global argmax
    res = sharded_restart_opt(mesh, Rprop(iterations=10),
                              lambda Z: acqui(gp, Z, FirstElem, 1),
                              torch.full((d,), 0.5, **kw), gen, True,
                              restarts_per_device=2, axis="restarts")
    # (3) the row-sharded posterior mean over the candidate batch
    mu_q = row_sharded_posterior_mean(mesh, gp.kernel,
                                      gp.x * gp.mask[:, None], gp.alpha,
                                      gp.mean(Xq), Xq, axis="restarts")
    # (4) evaluate (a synthetic objective on the device) and append
    gp = gp_mod.add_sample(gp, res.x, torch.sin(torch.sum(res.x))[None])
    _check(gp.n == n + 1 and mu_q.shape == (q, 1) and _finite(mu_q),
           "train step")
    out = dict(restart_x=res.x, restart_value=res.value, mu_q=mu_q,
               gp_mean=gp_mod.query(gp, Xq)[0])

    # ---- the sharded blocked Cholesky: exact fit + query, the factor's
    # rows split over the mesh (parallel/sharded_chol.py) ----
    from limbo_tpu_torch.parallel.sharded_chol import (sharded_fit,
                                                       sharded_query)

    B = PANEL_BLOCK
    Xs = torch.rand((B * n_dev, d), generator=gen, **kw)
    sgp = sharded_fit(mesh, kernel, DataMean.create(dim_out=1, **kw), Xs,
                      torch.cos(Xs.sum(dim=1, keepdim=True)), block=B,
                      axis="restarts")
    mu_s, var_s = sharded_query(mesh, sgp, Xq)
    _check(_finite(mu_s) and bool((var_s >= 0.0).all()), "sharded query")
    out.update(sharded_mu=mu_s, sharded_var=var_s)

    # ---- the column-sharded cached acquisition and deferred append
    # (parallel/sharded_acq.py) ----
    from limbo_tpu_torch.parallel.sharded_acq import (make_sharded_bo_iter,
                                                      shard_cache_cols)

    def objective(x):
        return torch.sin(torch.sum(x))[None]

    mesh_c = make_mesh(n_dev, axis_name="cols")
    gp_c = gp_mod.fit(kernel, DataMean.create(dim_out=1, **kw), X, Y,
                      capacity=64 * n_dev, device=dev)
    cache_c = shard_cache_cols(mesh_c, gp_mod.QueryCache.build(
        gp_c, with_Linv=True, qdtype=torch.bfloat16, defer_m=4))
    opt = RandomRestarts(sub=Rprop(iterations=5), repeats=4,
                         sweep_samples=16)
    iter_c = make_sharded_bo_iter(mesh_c, objective, acqui, opt)
    gp_c, cache_c, x_c, _ = iter_c(gp_c, cache_c, gen, 0)
    _check(gp_c.n == n + 1 and _finite(x_c), "column-sharded iteration")
    out.update(cols_x=x_c)

    # ---- beyond-one-card BO (parallel/sharded_big.py): row-sharded
    # factor -> column-sharded K^-1 panels -> one BO iteration with the
    # distributed-solve append ----
    from limbo_tpu_torch.parallel.sharded_big import (make_big_bo_iter,
                                                      sharded_cache_from_fit)

    Nb = B * n_dev
    mesh_b = make_mesh(n_dev, axis_name="rows")
    Xb = torch.zeros((Nb, d), **kw)
    Yb = torch.zeros((Nb, 1), **kw)
    Xb[:n], Yb[:n] = X, Y
    sgp_b = sharded_fit(mesh_b, kernel, DataMean.create(dim_out=1, **kw),
                        Xb, Yb, n=n, block=B, axis="rows")
    big = sharded_cache_from_fit(mesh_b, sgp_b, defer_m=4)
    iter_b = make_big_bo_iter(mesh_b, objective, acqui, opt)
    big, x_b, _ = iter_b(big, gen, 0)
    _check(big.n == n + 1 and _finite(x_b) and _finite(big.Kq),
           "beyond-one-card iteration")
    out.update(big_x=x_b)

    # ---- 2-D mesh (restarts x rows): candidate fan-out on one axis with
    # row-sharded posterior means and a psum on the other ----
    if n_dev >= 4 and n_dev % 2 == 0:
        out.update(run_dryrun_2d(gp, n_dev))
    return out


def run_dryrun_2d(gp, n_devices: int) -> dict:
    mesh2 = make_mesh_2d(n_devices // 2, 2)
    rs, rw = mesh_axis(mesh2, "restarts"), mesh_axis(mesh2, "rows")
    R = 4 * rs.size
    gen = torch.Generator(device=gp.x.device).manual_seed(7)
    cands = torch.rand((R, gp.dim_in), generator=gen, dtype=gp.x.dtype,
                       device=gp.x.device)
    x_rows = gp.x * gp.mask[:, None]
    nr = gp.capacity // rw.size
    rows = slice(rw.rank * nr, (rw.rank + 1) * nr)
    nc = R // rs.size
    c_s = cands[rs.rank * nc:(rs.rank + 1) * nc]
    # each candidate's mean without the prior term, rows psum'd
    vals = psum(gp.kernel.gram(c_s, x_rows[rows]) @ gp.alpha[rows],
                rw)[:, 0]
    i = torch.argmax(vals)
    vs = all_gather(vals[i].reshape(1), rs)
    xs = all_gather(c_s[i][None, :], rs)
    j = torch.argmax(vs)
    best_v = vs[j]
    # cross-check against the unsharded posterior (the prior-mean term,
    # constant, added back)
    mu_all, _ = gp_mod.query(gp, cands)
    mu_best = mu_all[torch.argmax(mu_all[:, 0]), 0]
    off = gp.mean(cands[:1])[0, 0]
    _check(bool(torch.abs(best_v + off - mu_best)
                < 1e-4 * (1.0 + torch.abs(mu_best))), "2-D mesh argmax")
    return dict(mesh2d_x=xs[j], mesh2d_value=best_v + off)
