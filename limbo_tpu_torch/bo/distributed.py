"""Beyond-one-card BO with the BOptimizer surface (port of
limbo_tpu/bo/distributed.py).

``DistributedBOptimizer(mesh, ...)`` runs the classic loop (init design ->
fit -> {propose, evaluate, append}*, with stats, stop criteria and
ask/tell) with the model spread over the ranks of a mesh:

  * fit: the row-split blocked Cholesky
    (``parallel.sharded_chol.sharded_fit``);
  * query cache: column-split K^{-1} panels solved from the split factor
    (``parallel.sharded_big.sharded_cache_from_fit``);
  * each iteration: the column-split acquisition and the distributed-solve
    append (``parallel.sharded_big.make_big_propose`` / ``make_big_add``),

so no N x N buffer is ever whole on one card.  Every rank runs the same
loop: the objective is evaluated on every rank (or on one and its value
shared by the caller), the proposals are equal bit for bit across ranks
because every rank draws from a generator seeded alike.

API parity with BOptimizer: optimize(f, ...), init_state / ask / tell,
stats writers, chained stop criteria, NaN guards.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from limbo_tpu_torch.acqui.acqui import UCB, FirstElem
from limbo_tpu_torch.bo.init_designs import RandomSampling
from limbo_tpu_torch.bo.optimizer import (BOptimizer, BOState,
                                          default_acqui_optimizer)
from limbo_tpu_torch.bo.stop import MaxIterations
from limbo_tpu_torch.kernels import MaternFiveHalves
from limbo_tpu_torch.means import DataMean
from limbo_tpu_torch.parallel.mesh import mesh_axis, mesh_device
from limbo_tpu_torch.parallel.sharded_chol import DEFAULT_BLOCK
from limbo_tpu_torch.utils.sysinfo import make_res_dir


class DistributedBOptimizer:
    """The classic BO loop with the GP spread over a mesh's `axis`.

    Same slots as BOptimizer (kernel, mean, acqui, acqui_optimizer, init,
    stop, stats); ``block`` is the sharded Cholesky's block (the panel
    kernel's, DEFAULT_BLOCK, on the card) and ``defer_m`` the deferred
    append's flush period (parallel/sharded_big.py).  ``qdtype`` (e.g.
    torch.bfloat16) stores the K^{-1} panels in low precision, halving
    each acquisition's read at bf16 accuracy; a flush then rebuilds the
    panels, a cache build's cost.  The device is the mesh's: this rank's
    card, or the CPU for a gloo mesh."""

    def __init__(self, mesh, kernel=None, mean=None, acqui=None,
                 acqui_optimizer=None, init=None, stop: Sequence = None,
                 stats: Sequence = (), stats_enabled: bool = True,
                 res_base_dir: Optional[str] = None,
                 block: int = DEFAULT_BLOCK, defer_m: int = 64, qdtype=None,
                 bounded: bool = True, axis: str = "rows",
                 dtype=torch.float32):
        self.mesh = mesh
        self.device = mesh_device(mesh)
        self.kernel = kernel
        self.mean = mean
        self.acqui = acqui if acqui is not None else UCB()
        self.acqui_optimizer = (acqui_optimizer if acqui_optimizer is not None
                                else default_acqui_optimizer())
        self.init = (init if init is not None
                     else RandomSampling(10, bounded=bounded))
        self.stop = tuple(stop) if stop is not None else (MaxIterations(190),)
        self.stats = tuple(stats)
        self.stats_enabled = stats_enabled
        self.block = block
        self.defer_m = defer_m
        self.qdtype = qdtype
        self.bounded = bounded
        self.axis = axis
        self.dtype = dtype
        self.res_dir = (make_res_dir(res_base_dir)
                        if (stats_enabled and res_base_dir is not None
                            and stats) else None)
        self._aggregator = FirstElem

    # -- geometry ------------------------------------------------------------

    def _capacity(self, need: int) -> int:
        """Padded size: a multiple of n_ranks * block covering `need`."""
        unit = mesh_axis(self.mesh, self.axis).size * self.block
        return max(unit, -(-need // unit) * unit)

    def _slots(self, dim_out: int):
        kw = dict(device=self.device, dtype=self.dtype)
        kernel = (self.kernel if self.kernel is not None
                  else MaternFiveHalves.create(**kw))
        mean = (self.mean if self.mean is not None
                else DataMean.create(dim_out=dim_out, **kw))
        return kernel, mean

    _max_iterations = BOptimizer._max_iterations

    # -- fit + cache (the once-per-run sharded build) ------------------------

    def _fit(self, X: np.ndarray, Y: np.ndarray):
        """The sharded fit of the init design, padded to the capacity the
        run needs."""
        from limbo_tpu_torch.parallel.sharded_chol import sharded_fit

        n, d = X.shape
        p = Y.shape[1]
        kernel, mean = self._slots(p)
        cap = self._capacity(n + self._max_iterations() + 1)
        kw = dict(dtype=self.dtype, device=self.device)
        Xp = torch.zeros((cap, d), **kw)
        Yp = torch.zeros((cap, p), **kw)
        Xp[:n] = torch.as_tensor(X, **kw)
        Yp[:n] = torch.as_tensor(Y, **kw)
        return sharded_fit(self.mesh, kernel, mean, Xp, Yp, n=n,
                           block=self.block, axis=self.axis)

    def _build(self, sgp):
        """The column-split K^{-1} panels from the sharded factor."""
        from limbo_tpu_torch.parallel.sharded_big import \
            sharded_cache_from_fit

        return sharded_cache_from_fit(self.mesh, sgp, qdtype=self.qdtype,
                                      defer_m=self.defer_m)

    # -- the host-driven loop (optimize in terms of ask/tell) ----------------

    def optimize(self, f: Callable, dim_in: int, dim_out: int = 1,
                 aggregator: Callable = FirstElem,
                 generator: Optional[torch.Generator] = None) -> BOState:
        """f: (d,) numpy array -> (p,) observation, called on every rank."""
        state = self.init_state(dim_in, dim_out=dim_out,
                                aggregator=aggregator, generator=generator)
        while state.pending_init:
            x = self.ask(state)
            self.tell(state, x, f(x))
        while not self._stopped(state):
            x = self.ask(state)
            self.tell(state, x, f(x))
        return state

    # -- ask/tell ------------------------------------------------------------

    def init_state(self, dim_in: int, dim_out: int = 1,
                   aggregator: Callable = FirstElem,
                   generator: Optional[torch.Generator] = None) -> BOState:
        """Queue the init design for the first ask() calls.  The generator
        (default: seeded with 0) must be seeded alike on every rank."""
        gen = (generator if generator is not None
               else torch.Generator(device=self.device).manual_seed(0))
        self._aggregator = aggregator
        state = BOState(gp=None, generator=gen, aggregator=aggregator)
        state.pending_init = list(
            self.init(gen, dim_in, dtype=self.dtype).cpu().numpy())
        state._init_xy = ([], [])            # accumulated until the fit
        return state

    def ask(self, state: BOState) -> np.ndarray:
        if state.pending_init:
            return np.asarray(state.pending_init[0])
        from limbo_tpu_torch.parallel.sharded_big import make_big_propose

        propose = make_big_propose(self.mesh, self.acqui,
                                   self.acqui_optimizer,
                                   aggregator=self._aggregator,
                                   bounded=self.bounded)
        x, value = propose(state.gp, state.generator, state.total_iterations)
        host = torch.cat([x, value.reshape(1)]).cpu().numpy()
        state.last_acqui_value = float(host[-1])
        return host[:-1]

    def tell(self, state: BOState, x, y) -> BOState:
        """Feed y = f(x) back (NaN/Inf raises EvaluationError); init-design
        points are kept until the last, then the sharded fit and cache
        build run."""
        from limbo_tpu_torch.parallel.sharded_big import make_big_add

        y = BOptimizer._checked(y, x)
        x = np.asarray(x)
        if state.pending_init:
            state.pending_init.pop(0)
            state._init_xy[0].append(x)
            state._init_xy[1].append(y)
            if not state.pending_init:
                X = np.stack(state._init_xy[0])
                Y = np.stack(state._init_xy[1]).reshape(len(X), -1)
                state.gp = self._build(self._fit(X, Y))
            return state
        kw = dict(dtype=self.dtype, device=self.device)
        state.gp = make_big_add(self.mesh)(state.gp, torch.as_tensor(x, **kw),
                                           torch.as_tensor(y, **kw))
        state.last_sample = x
        state.last_observation = y
        state.iteration += 1
        state.total_iterations += 1
        self._update_stats(state)
        return state

    # -- shared plumbing -----------------------------------------------------

    _stopped = BOptimizer._stopped
    _update_stats = BOptimizer._update_stats
