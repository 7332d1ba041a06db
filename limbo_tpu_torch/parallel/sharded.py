"""Sharded compute paths: acquisition fan-out, population evaluation and
row-sharded posterior means (port of limbo_tpu/parallel/sharded.py).

The multi-card forms of limbo's intra-process parallelism (TBB par::loop /
par::max, tools/parallel.hpp:139-168):

* ``sharded_restart_opt``: optimizer restarts split over the mesh's
  "restarts" axis, each rank running its share as one batch, then a
  global argmax over the ranks' winners (two small all_gathers);
* ``make_sharded_pop_eval``: a population's evaluation split over the
  ranks and gathered back (CMA-ES's and NSGA-II's ``mesh``);
* ``row_sharded_posterior_mean``: the posterior mean over a candidate
  batch with the training rows split over the ranks and a psum.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from limbo_tpu_torch.opt.base import OptResult, take
from limbo_tpu_torch.parallel.mesh import all_gather, mesh_axis, psum


def _rows(ax, n: int):
    """This rank's slice of n rows split evenly over the axis."""
    if n % ax.size:
        raise ValueError(f"{n} rows not divisible by mesh axis "
                         f"'{ax.name}' size {ax.size}")
    k = n // ax.size
    return slice(ax.rank * k, (ax.rank + 1) * k)


def sharded_restart_opt(mesh, sub_opt, fun: Callable, init: torch.Tensor,
                        generator: torch.Generator, bounded: bool,
                        restarts_per_device: int = 4,
                        axis: str = "restarts") -> OptResult:
    """Run (n_ranks * restarts_per_device) restarts of `sub_opt` on `fun`
    split across the mesh; return the global best.

    Every rank draws the same starts from its generator (seed them alike),
    runs its own block of them as one batch (the optimizers' batched
    protocol, opt/base.py), and the ranks' winners are gathered and
    compared: one latency-bound hop, negligible next to the ascent."""
    ax = mesh_axis(mesh, axis)
    total = ax.size * restarts_per_device
    inits = torch.rand((total, init.shape[0]), generator=generator,
                       dtype=init.dtype, device=init.device)
    inits[0] = init
    res = sub_opt(fun, inits[_rows(ax, total)], generator, bounded)
    i = torch.argmax(res.value)
    xs = all_gather(take(res.x, i)[None, :], ax)           # (n_ranks, d)
    vs = all_gather(take(res.value, i).reshape(1), ax)     # (n_ranks,)
    j = torch.argmax(vs)
    return OptResult(x=take(xs, j), value=take(vs, j))


def make_sharded_pop_eval(mesh, fun: Callable,
                          axis: Optional[str] = None) -> Callable:
    """Population evaluation split over the mesh: an eval function (P, d)
    -> the batched ``fun``'s outputs for all P, each rank evaluating its
    block of the population and the blocks gathered back in order (the
    multi-card form of libcmaes's ``set_mt_feval(true)``, opt/cmaes.hpp:
    272, and of sferes2's TBB evaluator, bo_multi.hpp:184).  P must be a
    multiple of the axis size."""
    ax = mesh_axis(mesh, axis)

    def eval_fn(X: torch.Tensor) -> torch.Tensor:
        return all_gather(fun(X[_rows(ax, X.shape[0])]).contiguous(), ax)

    return eval_fn


def row_sharded_posterior_mean(mesh, kernel, x_rows: torch.Tensor,
                               alpha_rows: torch.Tensor,
                               mean_q: torch.Tensor, Xq: torch.Tensor,
                               axis: Optional[str] = None) -> torch.Tensor:
    """mu(Xq) = K(Xq, X) alpha + m(Xq) with the training rows split over
    the mesh: each rank forms its (q, p) partial product from its rows of
    x_rows (N, d) and alpha_rows (N, p), and a psum combines them.  Every
    argument is replicated; N must be a multiple of the axis size."""
    ax = mesh_axis(mesh, axis)
    r = _rows(ax, x_rows.shape[0])
    ks = kernel.gram(Xq, x_rows[r])                         # (q, N/D)
    return psum(ks @ alpha_rows[r], ax) + mean_q
