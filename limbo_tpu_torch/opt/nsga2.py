"""NSGA-II over a population batch (port of limbo_tpu/opt/nsga2.py).

Reference capability: limbo's multi-objective layer drives sferes2's NSGA-II
(experimental/bayes_opt/bo_multi.hpp:184 update_pareto_model runs
sferes::ea::Nsga2 over the GP means).  Deb et al. 2002: fast non-dominated
sorting, crowding distance, binary tournament, SBX crossover, polynomial
mutation, with the population a batch axis: evaluation, ranking (a peel of
the dominance matrix), crowding and variation are tensor operations.

The ranking peels in groups of ``PEEL_CHECK`` and reads from the device
whether any point is left after each group, so it runs as many peels as
the population has fronts (rounded up to the group) where the reference
scans all P; the ranks are the same.  Sorts are stable, as jnp.argsort is:
the sort keys ``rank * 1e30 + y`` (crowding) and ``rank * 1e30 - crowd``
(selection) lose y and ordinary crowding distances to rounding for every
rank past 0, so those ties fall to the index, as in the reference.

Convention: MAXIMIZATION of all objectives, search space [0, 1]^d.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from limbo_tpu_torch.ops.pareto import dominance_matrix

BIG = 1e30
PEEL_CHECK = 8


def _ranks(Y: torch.Tensor) -> torch.Tensor:
    """Fast non-dominated sorting by iterative peeling (rank 0 = front)."""
    P = Y.shape[0]
    dom = dominance_matrix(Y)                       # dom[i, j]: j dominates i
    remaining = torch.ones(P, dtype=torch.bool, device=Y.device)
    rank = torch.zeros(P, dtype=torch.int32, device=Y.device)
    r = 0
    while r < P:
        for _ in range(min(PEEL_CHECK, P - r)):
            blocked = torch.any(dom & remaining[None, :], dim=1)
            nd = ~blocked & remaining
            rank = torch.where(nd, torch.full_like(rank, r), rank)
            remaining = remaining & ~nd
            r += 1
        if not bool(remaining.any()):
            break
    return rank


def _crowding(Y: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Crowding distance per front, one objective at a time."""
    P, M = Y.shape
    crowd = torch.zeros(P, dtype=Y.dtype, device=Y.device)
    seg = rank.to(torch.int64)
    for m in range(M):
        # sort within fronts: key = rank * BIG + value (stable)
        key = rank.to(Y.dtype) * BIG + Y[:, m]
        order = torch.argsort(key, stable=True)
        y_s = Y[order, m]
        r_s = rank[order]
        hi = torch.full((P,), -torch.inf, dtype=Y.dtype, device=Y.device)
        lo = torch.full((P,), torch.inf, dtype=Y.dtype, device=Y.device)
        hi = hi.scatter_reduce(0, seg, Y[:, m], "amax", include_self=False)
        lo = lo.scatter_reduce(0, seg, Y[:, m], "amin", include_self=False)
        span = torch.clamp(hi - lo, min=1e-12)     # empty segments: 1e-12
        big = torch.full((1,), BIG, dtype=Y.dtype, device=Y.device)
        gap = (torch.cat([big, y_s[2:] - y_s[:-2], big]) if P > 2
               else torch.full((P,), BIG, dtype=Y.dtype, device=Y.device))
        # a front's boundary (a neighbour of another rank) -> BIG
        edge = torch.full((1,), -1, dtype=rank.dtype, device=Y.device)
        prev_r = torch.cat([edge, r_s[:-1]])
        next_r = torch.cat([r_s[1:], edge])
        boundary = (prev_r != r_s) | (next_r != r_s)
        d = torch.where(boundary, BIG, gap / span[r_s.to(torch.int64)])
        crowd = crowd.index_add(0, order, torch.clamp(d, max=BIG))
    return crowd


def _tournament(rank: torch.Tensor, crowd: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Binary tournament on (rank ascending, crowd descending) between the
    pairs idx (2, n) of indices drawn in [0, P); returns n winners."""
    a, b = idx[0], idx[1]
    a_better = (rank[a] < rank[b]) | ((rank[a] == rank[b])
                                      & (crowd[a] > crowd[b]))
    return torch.where(a_better, a, b)


def _sbx(u: torch.Tensor, X1: torch.Tensor, X2: torch.Tensor,
         eta: float = 15.0) -> torch.Tensor:
    """Simulated binary crossover per gene, from the uniforms u."""
    beta = torch.where(u <= 0.5,
                       (2 * u) ** (1.0 / (eta + 1)),
                       (1.0 / (2 * (1 - u))) ** (1.0 / (eta + 1)))
    c1 = 0.5 * ((1 + beta) * X1 + (1 - beta) * X2)
    return torch.clamp(c1, 0.0, 1.0)


def _poly_mutation(u: torch.Tensor, v: torch.Tensor, X: torch.Tensor,
                   eta: float = 20.0, rate: float = None) -> torch.Tensor:
    """Polynomial mutation from the uniforms u (the step) and v (whether a
    gene mutates: v < rate, default 1/d)."""
    d = X.shape[-1]
    rate = rate if rate is not None else 1.0 / d
    do = v < rate
    delta = torch.where(u < 0.5,
                        (2 * u) ** (1.0 / (eta + 1)) - 1.0,
                        1.0 - (2 * (1 - u)) ** (1.0 / (eta + 1)))
    return torch.clamp(X + torch.where(do, delta, torch.zeros_like(delta)),
                       0.0, 1.0)


@dataclass
class Nsga2:
    """Batched NSGA-II.  Call with a batched multi-objective function."""

    pop_size: int = 100
    generations: int = 50
    eta_c: float = 15.0
    eta_m: float = 20.0
    # optional DeviceMesh: the population's evaluation splits over
    # `mesh_axis` (default its first dimension; parallel/sharded.
    # make_sharded_pop_eval), pop_size rounded up to a multiple of the
    # axis size; every rank runs the rest, from draws seeded alike
    mesh: object = None
    mesh_axis: str = None

    def __call__(self, fun: Callable, dim: int, generator: torch.Generator,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """fun: (P, d) -> (P, M) objectives to maximize, on the generator's
        device.  Returns the final population (X (P, d), Y (P, M)); the
        caller extracts fronts with ops.pareto."""
        P = self.pop_size
        if self.mesh is not None:
            from limbo_tpu_torch.parallel.mesh import mesh_axis
            from limbo_tpu_torch.parallel.sharded import make_sharded_pop_eval

            size = mesh_axis(self.mesh, self.mesh_axis).size
            P = -(-P // size) * size
            fun = make_sharded_pop_eval(self.mesh, fun, axis=self.mesh_axis)
        kw = dict(generator=generator, dtype=dtype, device=generator.device)
        X = torch.rand((P, dim), **kw)
        Y = fun(X)
        for _ in range(self.generations):
            idx = torch.randint(0, P, (2, 2 * P), generator=generator,
                                device=generator.device)
            u_cx = torch.rand((P, dim), **kw)
            u_mut = torch.rand((P, dim), **kw)
            v_mut = torch.rand((P, dim), **kw)
            X, Y = self.generation(fun, X, Y, idx, u_cx, u_mut, v_mut)
        return X, Y

    def generation(self, fun: Callable, X, Y, idx, u_cx, u_mut, v_mut):
        """One generation given its draws: the tournament pairs idx
        (2, 2P), the crossover uniforms and the mutation's two (P, d)."""
        P = X.shape[0]
        rank = _ranks(Y)
        crowd = _crowding(Y, rank)
        parents = _tournament(rank, crowd, idx)
        child = _sbx(u_cx, X[parents[:P]], X[parents[P:]], self.eta_c)
        child = _poly_mutation(u_mut, v_mut, child, self.eta_m)
        Yc = fun(child)
        # environmental selection over the 2P union
        Xu = torch.cat([X, child])
        Yu = torch.cat([Y, Yc])
        rank_u = _ranks(Yu)
        crowd_u = _crowding(Yu, rank_u)
        # order by (rank asc, crowd desc), keep the best P
        score = (rank_u.to(Yu.dtype) * BIG
                 - torch.clamp(crowd_u, max=BIG / 2))
        order = torch.argsort(score, stable=True)[:P]
        return Xu[order], Yu[order]
