"""The Bayesian-optimization driver (port of limbo_tpu/bo/optimizer.py).

Reference: src/limbo/bayes_opt/bo_base.hpp:179 (BoBase: sample DB, init,
stats, stop chaining, NaN guards) and boptimizer.hpp:116 (BOptimizer: the
classic fit -> acquire -> evaluate -> update loop, with periodic
hyperparameter re-optimization via hp_period, boptimizer.hpp:163).

* The GP lives in fixed-capacity padded buffers sized once from the init
  design, the iteration budget and a bucket (``_capacity``), so every
  iteration runs on tensors of the same shapes; a resumed run grows them.
* Two drive modes: ``optimize(f, ...)``, the host loop around an arbitrary
  Python objective (limbo's model: control leaves the library at
  eval_and_add, bo_base.hpp:232), and ``init_state`` / ``ask`` / ``tell``
  for objectives that cannot be wrapped in a callable.  Per iteration the
  loop reads the card once: the proposal, its acquisition value and its
  predicted mean come back in one copy, which the objective needs anyway.
* The acquisition optimizer defaults to batched multi-start gradient ascent
  plus a dense random sweep (the acquisitions are differentiable through the
  GP query), replacing limbo's NLOpt DIRECT-L-RAND / CMA-ES default chain
  (boptimizer.hpp:120-127); ``opt.DirectL`` and ``opt.Cmaes`` are the
  batched counterparts of those two, and run inside optimize_jit's
  captured iteration as well.
* Every draw (init design, sweep, restarts, hyperparameter restarts, a
  stop criterion's search) comes from one ``torch.Generator`` on the
  optimizer's device, where the reference splits a key.
* ``optimize_jit(f, ...)``, the device-resident loop for an objective
  written in torch on the device: the reference's one ``lax.scan``
  becomes one captured iteration (bo/graph.py) replayed once an iteration,
  with nothing read back from the card unless the run needs it (the
  exact append's finiteness flag, a stop criterion's decision).

* The model families (limbo's modelfun<...> genericity, bo_base.hpp:113):
  ``model_type`` "gp" (exact, rank-1 appends, optionally through the K^{-1}
  query cache and its append modes, or capped at ``max_model_points`` by
  SparsifiedGP's density-based removal), "spgp" (FITC pseudo-inputs,
  learned by ``models.spgp.SPGPHpOpt`` on the hp cadence) or "iterative"
  (CG, no Cholesky, re-solved every ``model_refit_period`` iterations),
  with ``model_options`` (spgp's ``m``; iterative's ``block``, ``cg_tol``,
  ``cg_maxiter``).  ``optimize_jit`` runs the exact GP only, as the
  reference's does.

* ``optimize_batch(f, ...)``, batch BO: each round proposes a joint
  q-point batch by maximizing Monte Carlo q-EI (acqui/qei.py) and
  evaluates all q points.  The multi-objective loops are in bo/multi.py.

The constrained loop is bo/cbo.py, IMGPO bo/imgpo.py, and a run's
checkpoint and resume bo/checkpoint.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from limbo_tpu_torch.acqui.acqui import EI, UCB, FirstElem
from limbo_tpu_torch.bo.graph import BOStep, Captured
from limbo_tpu_torch.bo.init_designs import RandomSampling
from limbo_tpu_torch.bo.stop import MaxIterations
from limbo_tpu_torch.kernels import MaternFiveHalves
from limbo_tpu_torch.means import DataMean
from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.models.dispatch import add_sample_any, query_any
from limbo_tpu_torch.opt.compose import RandomRestarts
from limbo_tpu_torch.opt.gradient import Rprop
from limbo_tpu_torch.utils.device import resolve_device
from limbo_tpu_torch.utils.sysinfo import make_res_dir


class EvaluationError(Exception):
    """Raised on NaN/Inf observations (limbo bo_base.hpp:106,232-238)."""


# the cached-append modes of models/gp.add_sample_cached
_FAST_UPDATES = (False, True, "refined", "linv", "deferred")


def default_acqui_optimizer() -> RandomRestarts:
    """Batched multi-start ascent + random sweep (the DIRECT replacement):
    64 restarts x Rprop(20) from the best of a 1024-point sweep
    (limbo_tpu/bo/optimizer.py:53-65)."""
    return RandomRestarts(sub=Rprop(iterations=20), repeats=64,
                          sweep_samples=1024)


@dataclass
class BOState:
    """Host-side view of a running optimization (mutable between steps)."""

    gp: gp_mod.GP
    generator: torch.Generator
    iteration: int = 0
    total_iterations: int = 0
    aggregator: Callable = FirstElem
    last_sample: Optional[np.ndarray] = None
    last_observation: Optional[np.ndarray] = None
    last_acqui_value: Optional[float] = None
    last_prediction: Optional[np.ndarray] = None
    cache: Optional[gp_mod.QueryCache] = None
    # init-design points not yet evaluated (ask/tell flow only; optimize()
    # evaluates the whole design up front)
    pending_init: Optional[list] = None

    # -- best-so-far (limbo best_observation/best_sample,
    #    boptimizer.hpp:174-188) --------------------------------------------
    @property
    def _agg_obs(self) -> np.ndarray:
        with torch.no_grad():
            agg = self.aggregator(gp_mod.observations(self.gp))
        return agg.cpu().numpy()

    @property
    def best_index(self) -> int:
        return int(np.argmax(self._agg_obs))

    @property
    def best_observation(self) -> np.ndarray:
        return gp_mod.observations(self.gp)[self.best_index].cpu().numpy()

    @property
    def best_sample(self) -> np.ndarray:
        return gp_mod.samples(self.gp)[self.best_index].cpu().numpy()

    @property
    def best_value(self) -> float:
        agg = self._agg_obs
        return float(np.max(agg)) if agg.size else -np.inf


class BOptimizer:
    """The classic single-objective BO loop (limbo BOptimizer).

    Defaults as the reference's: Matérn-5/2 + DataMean (limbo GPBasic,
    model/gp.hpp:637), UCB, ``default_acqui_optimizer()``,
    ``RandomSampling(10)`` and ``MaxIterations(190)``.  The K^{-1} query
    cache (``use_query_cache``) takes ``cache_fast_update`` False (two
    triangular solves per append), "refined" (u = K^{-1} k polished by one
    refinement step against a maintained K), True (raw u = K^{-1} k,
    drifting; pair it with a short refresh period), "linv" (two triangle
    matvecs on a maintained L^{-1}) or "deferred" ("linv" with the N x N
    rewrite amortized into one product per ``cache_defer_m`` appends;
    constant-type means only), an optional low-precision query mirror
    (``cache_query_dtype``, e.g. torch.bfloat16), ``cache_lite`` (deferred
    only: no f32 K^{-1} master, the mirror is the only N x N query matrix)
    and an exact rebuild every ``cache_refresh_period`` appends.
    """

    def __init__(self,
                 kernel=None,
                 mean=None,
                 acqui=None,
                 acqui_optimizer=None,
                 init=None,
                 stop: Sequence = None,
                 stats: Sequence = (),
                 hp_opt=None,
                 hp_period: int = -1,
                 bounded: bool = True,
                 stats_enabled: bool = True,
                 res_base_dir: Optional[str] = None,
                 use_query_cache: bool = False,
                 cache_fast_update=False,
                 cache_refresh_period: int = 64,
                 cache_query_dtype=None,
                 cache_defer_m: int = 32,
                 cache_lite: bool = False,
                 max_model_points: Optional[int] = None,
                 model_type: str = "gp",
                 model_options: Optional[dict] = None,
                 model_refit_period: int = 1,
                 dtype=torch.float32,
                 device="cuda"):
        self.device = resolve_device(device)
        if cache_lite and cache_fast_update != "deferred":
            raise ValueError("cache_lite requires cache_fast_update="
                             "'deferred' (lite flushes apply the deferred "
                             "pivot corrections to the mirror)")
        if cache_fast_update not in _FAST_UPDATES:
            raise ValueError(f"unknown cache_fast_update "
                             f"{cache_fast_update!r}")
        if model_type not in ("gp", "spgp", "iterative"):
            raise ValueError(f"unknown model_type {model_type!r}")
        # exact-GP-only features: the query cache and the GP strategies of
        # models/hp_opt.py need the Cholesky state that SPGP and
        # IterativeGP do not carry; SPGP has its own SPGPHpOpt
        if model_type != "gp":
            if use_query_cache:
                raise ValueError(
                    f"use_query_cache requires model_type='gp' "
                    f"(got {model_type!r}: no Cholesky factor to cache)")
            if hp_opt is not None:
                from limbo_tpu_torch.models.spgp import SPGPHpOpt
                if not (model_type == "spgp"
                        and isinstance(hp_opt, SPGPHpOpt)):
                    raise ValueError(
                        f"hp_opt for model_type={model_type!r} must be a "
                        f"models.spgp.SPGPHpOpt (spgp only); the GP "
                        f"strategies in models/hp_opt.py need the exact-GP "
                        f"Cholesky state")
            elif hp_period > 0:
                raise ValueError(
                    f"hp_period > 0 without hp_opt does nothing for "
                    f"model_type={model_type!r}")
            if max_model_points is not None:
                raise ValueError(
                    "max_model_points (SparsifiedGP) requires model_type='gp'")
        self.kernel = kernel
        self.mean = mean
        self.acqui = acqui if acqui is not None else UCB()
        self.acqui_optimizer = (acqui_optimizer if acqui_optimizer is not None
                                else default_acqui_optimizer())
        self.init = (init if init is not None
                     else RandomSampling(10, bounded=bounded))
        self.stop = tuple(stop) if stop is not None else (MaxIterations(190),)
        self.stats = tuple(stats)
        self.hp_opt = hp_opt
        self.hp_period = hp_period
        self.bounded = bounded
        self.stats_enabled = stats_enabled
        self.use_query_cache = use_query_cache
        self.cache_fast_update = cache_fast_update
        self.cache_refresh_period = cache_refresh_period
        self.cache_query_dtype = cache_query_dtype
        self.cache_defer_m = cache_defer_m
        self.cache_lite = cache_lite
        self.max_model_points = max_model_points
        self.model_type = model_type
        self.model_options = dict(model_options or {})
        self.model_refit_period = model_refit_period
        self.dtype = dtype
        self.res_dir = (make_res_dir(res_base_dir)
                        if (stats_enabled and res_base_dir is not None
                            and stats) else None)

    # -- defaults (GPBasic parity: Matern-5/2 + DataMean, model/gp.hpp:637) --

    def _make_gp(self, dim_in: int, dim_out: int, capacity: int) -> gp_mod.GP:
        kw = dict(device=self.device, dtype=self.dtype)
        kernel = (self.kernel if self.kernel is not None
                  else MaternFiveHalves.create(**kw))
        mean = (self.mean if self.mean is not None
                else DataMean.create(dim_out=dim_out, **kw))
        return gp_mod.empty(kernel, mean, dim_in, dim_out, capacity, **kw)

    def _make_model(self, dim_in: int, dim_out: int, capacity: int,
                    generator):
        """The empty model of ``model_type`` (limbo_tpu/bo/optimizer.py:
        245-265); spgp's pseudo-inputs are drawn from ``generator``."""
        if self.model_type == "gp":
            return self._make_gp(dim_in, dim_out, capacity)
        kw = dict(device=self.device, dtype=self.dtype)
        kernel = (self.kernel if self.kernel is not None
                  else MaternFiveHalves.create(**kw))
        mean = (self.mean if self.mean is not None
                else DataMean.create(dim_out=dim_out, **kw))
        opts = self.model_options
        if self.model_type == "spgp":
            from limbo_tpu_torch.models import spgp

            return spgp.empty(kernel, mean, dim_in, dim_out,
                              m=opts.get("m", 16), capacity=capacity,
                              generator=generator, **kw)
        from limbo_tpu_torch.models import iterative

        return iterative.empty(
            kernel, mean, dim_in, dim_out, capacity=capacity,
            block=opts.get("block", 2048), cg_tol=opts.get("cg_tol", 1e-5),
            cg_maxiter=opts.get("cg_maxiter", 256), **kw)

    def _refit_model(self, model):
        """Full re-solve for models whose appends leave them stale
        (IterativeGP's CG alpha); the others are consistent after an
        append."""
        if self.model_type == "iterative":
            from limbo_tpu_torch.models import iterative

            return iterative.refit(model)
        return model

    def _max_iterations(self) -> int:
        for s in self.stop:
            if isinstance(s, MaxIterations):
                return s.iterations
        return 190

    def _capacity(self, extra: int = 0) -> int:
        """Padded buffer size, bucketed so near-miss configurations share
        shapes: multiples of 256 up to 2048, then of 1024."""
        need = self.init.count + self._max_iterations() + extra + 1
        if need <= 2048:
            return max(256, -(-need // 256) * 256)
        return -(-need // 1024) * 1024

    def _generator(self, generator) -> torch.Generator:
        if generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(0)

    # -- the host-driven loop ------------------------------------------------

    def optimize(self, f: Callable, dim_in: int, dim_out: int = 1,
                 aggregator: Callable = FirstElem, reset: bool = True,
                 generator: Optional[torch.Generator] = None,
                 state: Optional[BOState] = None) -> BOState:
        """Run BO with a host-evaluated objective.

        f: (d,) numpy array -> (p,) array-like observation.
        reset=False resumes from `state`, keeping its samples and
        total_iterations (limbo bo_base.hpp:249-260, boptimizer.hpp:139-141)
        and growing the buffers when this run's budget needs more room.
        As in the reference, a resumed state keeps the aggregator it was
        made with for best_value, best_index and best_sample, while this
        call's ``aggregator`` drives the proposals.
        generator: the draws' torch.Generator on this optimizer's device
        (default: seeded with 0).
        """
        gen = self._generator(generator)
        self._aggregator = aggregator
        if reset or state is None:
            gp = self._make_model(dim_in, dim_out, self._capacity(), gen)
            state = BOState(gp=gp, generator=gen, aggregator=aggregator)
            # ---- init design (bo_base.hpp:249, init/*.hpp) ----
            X0 = self.init(gen, dim_in, dtype=self.dtype).cpu().numpy()
            for x in X0:
                state.gp = self._add(state.gp, x, self._checked(f(x), x))
            state.gp = self._refit_model(state.gp)
        else:
            state.iteration = 0  # current-run counter resets; total continues
            need = self._capacity(extra=state.gp.n)
            if need > state.gp.capacity:
                if self.model_type != "gp":
                    raise NotImplementedError(
                        f"resume past capacity needs gp_mod.grow, which is "
                        f"exact-GP only (model_type={self.model_type!r}); "
                        f"restart with a larger MaxIterations budget instead")
                state.gp = gp_mod.grow(state.gp, need)
                state.cache = None     # rebuilt below at the new capacity
        if self.use_query_cache and state.cache is None:
            state.cache = self._build_cache(state.gp)
        state.generator = gen
        while not self._stopped(state):
            x_next = self._propose(state)
            self._ingest(state, x_next, self._checked(f(x_next), x_next))
        return state

    def _maximize(self, model, iteration, generator):
        """The acquisition optimizer's result over ``model`` at
        ``iteration`` (a number, or a device tensor in optimize_jit), on
        the device, with nothing read back."""
        acqui = self.acqui
        aggregator = getattr(self, "_aggregator", FirstElem)
        f_max = None
        if isinstance(acqui, EI):
            with torch.no_grad():
                f_max = acqui.best_predicted(model, aggregator)

        def acq_fn(X):
            if f_max is not None:
                return acqui(model, X, aggregator, iteration, f_max=f_max)
            return acqui(model, X, aggregator, iteration)

        start = torch.full((model.dim_in,), 0.5, dtype=self.dtype,
                           device=self.device)
        return self.acqui_optimizer(acq_fn, start, generator, self.bounded)

    def _propose(self, state: BOState) -> np.ndarray:
        """Maximize the acquisition over the current model; records its
        value and the predicted mean at the maximizer, and returns the
        maximizer, all three from one copy to the host."""
        model = (gp_mod.CachedGPView(state.gp, state.cache)
                 if self.use_query_cache else state.gp)
        res = self._maximize(model, state.total_iterations, state.generator)
        with torch.no_grad():
            mu, _ = query_any(model, res.x[None, :])
            host = torch.cat([res.x, res.value.reshape(1), mu[0]]
                             ).cpu().numpy()
        d = model.dim_in
        state.last_acqui_value = float(host[d])
        state.last_prediction = host[d + 1:]
        return host[:d]

    def _ingest(self, state: BOState, x: np.ndarray, y: np.ndarray) -> None:
        """Add one (x, y) observation and do all per-iteration bookkeeping:
        model/cache update by mode, counters, hp-opt cadence, stats."""
        if self.model_type != "gp":
            state.gp = self._add(state.gp, x, y)
            if (self.model_refit_period > 0 and
                    (state.total_iterations + 1)
                    % self.model_refit_period == 0):
                state.gp = self._refit_model(state.gp)
        elif self.use_query_cache:
            state.gp, state.cache = gp_mod.add_sample_cached(
                state.gp, state.cache, self._tensor(x), self._tensor(y),
                fast_update=self.cache_fast_update)
            if (self.cache_refresh_period > 0 and
                    (state.total_iterations + 1)
                    % self.cache_refresh_period == 0):
                state.gp = gp_mod.recompute(state.gp)
                state.cache = self._build_cache(state.gp)
        elif self.max_model_points is not None:
            state.gp = self._add_sparse(state.gp, x, y)
        else:
            state.gp = self._add(state.gp, x, y)
        state.last_sample = np.asarray(x)
        state.last_observation = np.asarray(y)
        state.iteration += 1
        state.total_iterations += 1
        # periodic hyperparameter re-optimization (boptimizer.hpp:163-165)
        if (self.hp_opt is not None and self.hp_period > 0
                and state.total_iterations % self.hp_period == 0):
            state.gp = self.hp_opt(state.gp, state.generator)
            if self.use_query_cache:
                state.cache = self._build_cache(state.gp)
        self._update_stats(state)

    # -- ask/tell (hardware-in-the-loop flow; no reference equivalent) -------

    def init_state(self, dim_in: int, dim_out: int = 1,
                   aggregator: Callable = FirstElem,
                   generator: Optional[torch.Generator] = None) -> BOState:
        """Start an ask/tell optimization: build the empty model and queue
        the init design for the first `self.init.count` ask() calls.

        The ask/tell flow serves objectives that cannot be wrapped in a
        callable (robot episodes, lab experiments, human raters): evaluate
        ask()'s point however and wherever you like, then feed it back with
        tell().  The same generator gives the same draws as optimize().
        """
        gen = self._generator(generator)
        self._aggregator = aggregator
        gp = self._make_model(dim_in, dim_out, self._capacity(), gen)
        state = BOState(gp=gp, generator=gen, aggregator=aggregator)
        state.pending_init = list(
            self.init(gen, dim_in, dtype=self.dtype).cpu().numpy())
        return state

    def ask(self, state: BOState) -> np.ndarray:
        """Next point to evaluate: the unevaluated init design first, then
        the acquisition maximizer over the current model."""
        if state.pending_init:
            return np.asarray(state.pending_init[0])
        if self.use_query_cache and state.cache is None:
            state.cache = self._build_cache(state.gp)
        return self._propose(state)

    def tell(self, state: BOState, x, y) -> BOState:
        """Feed the observation y = f(x) back (NaN/Inf raises
        EvaluationError, bo_base.hpp:232-238).  Init-design points don't
        count as iterations (matching optimize()); acquisition points run
        the full per-iteration bookkeeping incl. hp-opt cadence and stats."""
        y = self._checked(y, x)
        x = np.asarray(x)
        if state.pending_init:
            # match optimize()'s init phase: plain adds, no iteration count
            state.pending_init.pop(0)
            state.gp = self._add(state.gp, x, y)
            if not state.pending_init:
                state.gp = self._refit_model(state.gp)
                if self.use_query_cache:
                    state.cache = self._build_cache(state.gp)
            return state
        if self.use_query_cache and state.cache is None:
            state.cache = self._build_cache(state.gp)
        self._ingest(state, x, y)
        return state

    # -- pieces --------------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=self.dtype,
                            device=self.device)

    def _add(self, gp, x, y):
        return add_sample_any(gp, self._tensor(x), self._tensor(y))

    def _build_cache(self, gp):
        """The cache for this mode (limbo_tpu/bo/optimizer.py:506-523): K
        for "refined", Linv for "linv" and "deferred", lite as asked."""
        fast = self.cache_fast_update
        return gp_mod.QueryCache.build(
            gp, with_K=fast == "refined",
            with_Linv=fast in ("linv", "deferred"),
            qdtype=self.cache_query_dtype,
            defer_m=self.cache_defer_m if fast == "deferred" else 0,
            lite=self.cache_lite)

    def _add_sparse(self, gp, x, y):
        """The append of a GP capped at max_model_points (SparsifiedGP's:
        re-sparsify and refit when over budget)."""
        from limbo_tpu_torch.models import sparse_gp

        sgp = sparse_gp.SparsifiedGP(gp=gp, max_points=self.max_model_points)
        return sparse_gp.add_sample(sgp, self._tensor(x),
                                    self._tensor(y)).gp

    @staticmethod
    def _checked(y, x) -> np.ndarray:
        y = np.atleast_1d(np.asarray(y, dtype=np.float64))
        if not np.all(np.isfinite(y)):
            raise EvaluationError(f"invalid observation {y} at {x}")
        return y

    def _stopped(self, state: BOState) -> bool:
        # OR-fold like limbo's chained criteria (stop/chain_criteria.hpp:65)
        return any(bool(s(state)) for s in self.stop)

    def _update_stats(self, state: BOState):
        if not self.stats_enabled:
            return
        for stat in self.stats:
            stat(self, state)

    # -- the device-resident loop ---------------------------------------------

    def optimize_jit(self, f: Callable, dim_in: int, dim_out: int = 1,
                     aggregator: Callable = FirstElem,
                     generator: Optional[torch.Generator] = None,
                     n_iterations: Optional[int] = None
                     ) -> Tuple[BOState, dict]:
        """Run the whole BO loop on the device (limbo_tpu/bo/optimizer.py:
        616-750, its one ``lax.scan``): one iteration (the acquisition's
        maximizer, the objective, the append) is captured as a CUDA graph
        and replayed ``n_iterations`` times (default: the MaxIterations
        budget); on the CPU the same step runs eagerly.

        f: a torch function from a (d,) tensor to a (p,) tensor on this
        optimizer's device that never waits on the card (it is captured
        with the step).  The init design is evaluated and appended first,
        eagerly.  Stop criteria other than MaxIterations become a freeze
        mask: each needs ``device_stop``, checked after every iteration (and
        after the hp cadence) in a captured step of its own whose decision
        the host reads; the iterations after a stop emit NaN rows and -inf
        aggregates.  The hp cadence (every ``hp_period`` iterations) runs
        between replays, at the reference's place, and copies its learned
        hyperparameters, refit factor and rebuilt cache into the captured
        tensors.  As the reference's loop, this one has no periodic exact
        cache rebuild (``cache_refresh_period``) and writes no stats.

        Returns (BOState, history): history holds ``samples`` (iters, d),
        ``observations`` (iters, p), ``best`` (iters,), the cummax of the
        aggregated observations from the init design's best on, and
        ``effective_iterations``, all on the device, read by the caller,
        and ``capture_s``, the host seconds of the first iteration's
        warm-up and capture (0.0 on the CPU).
        """
        if self.model_type != "gp":
            raise NotImplementedError(
                f"optimize_jit runs the exact-GP loop only; model_type="
                f"{self.model_type!r} is supported by optimize()")
        mask_criteria = tuple(s for s in self.stop
                              if not isinstance(s, MaxIterations))
        for s in mask_criteria:
            if not hasattr(s, "device_stop"):
                raise TypeError(
                    f"stop criterion {type(s).__name__} lacks device_stop(); "
                    "it cannot run inside optimize_jit - use optimize()")
        gen = self._generator(generator)
        self._aggregator = aggregator
        iters = (n_iterations if n_iterations is not None
                 else self._max_iterations())
        kw = dict(dtype=self.dtype, device=self.device)
        gp = self._make_gp(dim_in, dim_out, self._capacity(
            extra=max(0, iters - self._max_iterations())))
        X0 = self.init(gen, dim_in, dtype=self.dtype)
        Y0 = [f(x).to(self.dtype).reshape(dim_out) for x in X0]
        for x, y in zip(X0, Y0):
            gp = add_sample_any(gp, x, y)
        cache = self._build_cache(gp) if self.use_query_cache else None
        with torch.no_grad():
            agg0 = aggregator(gp_mod.observations(gp))
            best0 = (torch.max(agg0) if agg0.numel()
                     else torch.tensor(-torch.inf, **kw))
        best = best0.clone()
        xs = torch.full((iters, dim_in), torch.nan, **kw)
        ys = torch.full((iters, dim_out), torch.nan, **kw)
        aggs = torch.full((iters,), -torch.inf, **kw)

        def record(it, x, y):
            a = aggregator(y[None, :])[0]
            row = it.reshape(1)
            xs.index_copy_(0, row, x[None, :])
            ys.index_copy_(0, row, y[None, :])
            aggs.index_copy_(0, row, a.reshape(1))
            best.copy_(torch.maximum(best, a))

        step = BOStep(gp, cache, lambda model, it: self._maximize(
            model, it, gen).x, f, gen, fast_update=self.cache_fast_update,
            on_sample=record)
        stopped = torch.zeros((), dtype=torch.bool, device=self.device)

        def check_stop():
            flag = torch.zeros((), dtype=torch.bool, device=self.device)
            for s in mask_criteria:
                flag = flag | s.device_stop(step.gp, best, gen, aggregator)
            stopped.copy_(flag)

        stop = Captured({None: check_stop}, gen, self.device)
        for it in range(iters):
            step.step()
            if (self.hp_opt is not None and self.hp_period > 0
                    and (it + 1) % self.hp_period == 0):
                fitted = self.hp_opt(step.gp, gen)
                step.assign(fitted, self._build_cache(fitted)
                            if self.use_query_cache else None)
            if mask_criteria:
                stop.run(None)
                if bool(stopped):
                    break
        history = {"samples": xs, "observations": ys,
                   "best": torch.cummax(torch.maximum(aggs, best0),
                                        dim=0).values,
                   "effective_iterations": torch.sum(torch.isfinite(aggs)),
                   "capture_s": step.graphs.setup_s}
        state = BOState(gp=step.gp, generator=gen, iteration=iters,
                        total_iterations=iters, aggregator=aggregator,
                        cache=step.cache)
        return state, history

    # -- batch proposals (q-EI; no limbo counterpart) -----------------------

    def optimize_batch(self, f: Callable, dim_in: int, q: int = 2,
                       dim_out: int = 1, aggregator: Callable = FirstElem,
                       generator: Optional[torch.Generator] = None,
                       qei=None, restarts: int = 16,
                       steps: int = 30) -> BOState:
        """Batch BO (limbo_tpu/bo/optimizer.py:567-612): each round
        proposes a joint q-point batch by maximizing Monte Carlo q-EI
        (acqui/qei.propose_batch: ``restarts`` starts ascended together by
        Rprop(``steps``)) and evaluates all q points, appended one by one.

        Stop criteria count ROUNDS (MaxIterations(30) means 30 batches,
        30 q evaluations); the buffers hold the init design and every
        round's q points.  generator: the draws' torch.Generator on this
        optimizer's device (default: seeded with 0)."""
        from limbo_tpu_torch.acqui.qei import propose_batch

        gen = self._generator(generator)
        self._aggregator = aggregator
        capacity = self._capacity(extra=(q - 1) * self._max_iterations())
        gp = self._make_model(dim_in, dim_out, capacity, gen)
        state = BOState(gp=gp, generator=gen, aggregator=aggregator)
        X0 = self.init(gen, dim_in, dtype=self.dtype).cpu().numpy()
        for x in X0:
            state.gp = self._add(state.gp, x, self._checked(f(x), x))
        state.gp = self._refit_model(state.gp)
        while not self._stopped(state):
            Xb, val = propose_batch(state.gp, q, gen, qei=qei,
                                    restarts=restarts, steps=steps,
                                    aggregator=aggregator)
            host = torch.cat([Xb.reshape(-1), val.reshape(1)]).cpu().numpy()
            Xb = host[:-1].reshape(q, dim_in)
            for x in Xb:
                state.gp = self._add(state.gp, x, self._checked(f(x), x))
            state.gp = self._refit_model(state.gp)
            state.last_sample = Xb
            state.last_acqui_value = float(host[-1])
            state.iteration += 1
            state.total_iterations += 1
            self._update_stats(state)
        return state
