"""Multi-objective Bayesian optimization: the BoMulti base, EHVI, NSBO and
ParEGO (port of limbo_tpu/bo/multi.py).

Reference: src/limbo/experimental/bayes_opt/{bo_multi,ehvi,nsbo,parego}.hpp
and experimental/model/gp_parego.hpp.

* BoMulti keeps one GP per objective (a MultiGP) and the Pareto fronts of
  the observed data and of the model (bo_multi.hpp:153-198); the model
  front comes from the batched NSGA-II (opt/nsga2.py) in place of sferes2.
* Ehvi (ehvi.hpp:82): each iteration maximizes the exact EHVI from every
  Pareto point as a seed.  limbo fans the seeds over TBB threads and calls
  the compiled ehvi2d per candidate (ehvi.hpp:128-147); here the seeds are
  one batched Rprop ascent on the differentiable EHVI, one query of all
  the seeds a step.  With q > 1 each seed is a jittered q-point batch and
  the ascent climbs the exact joint q-EHVI.  The observed front is held
  whole, as limbo's is: padded to the next multiple of FRONT_CAP rows, so
  the ascent's shapes change only when the front crosses a bucket, and
  every Pareto point is in the EHVI's box decomposition and is a seed.
  (The JAX package keeps an evenly spread 64-point subset of a longer
  front, which is another acquisition: the two agree on fronts of at most
  64 points.)  ``Ehvi.iterate`` is one iteration, in four torch.profiler
  spans (mo.refit, mo.front, mo.ascent, mo.eval); ``COUNTERS`` holds what
  the last one did.  On a CUDA device at q = 1 the ascent runs as one CUDA
  graph per front bucket (``_CapturedAscent``): eagerly it is ~25,000
  small kernels launched from Python an iteration, whose pace the host
  sets.
* Nsbo (nsbo.hpp:65): a random point of the variance Pareto front of the
  NSGA-II model front.
* Parego (parego.hpp:73, gp_parego.hpp:103): a random-weight augmented
  Chebyshev scalarization, y = max_j(l_j y_j) + rho * sum_j l_j y_j, and
  one single-objective BO step a iteration.

Every draw comes from a ``torch.Generator`` on the loop's device, where the
reference splits a key.  The loops default to f64, as the reference's do;
on the card the port's kernels take f32 only, so an f64 loop runs plain
PyTorch there.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from limbo_tpu_torch.bo.graph import Captured, assign_gp
from limbo_tpu_torch.bo.init_designs import RandomSampling
from limbo_tpu_torch.bo.optimizer import BOptimizer, EvaluationError
from limbo_tpu_torch.bo.stop import MaxIterations
from limbo_tpu_torch.kernels import MaternFiveHalves
from limbo_tpu_torch.means import DataMean, NullMean
from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.models import multi_gp
from limbo_tpu_torch.opt.base import take
from limbo_tpu_torch.opt.gradient import Rprop
from limbo_tpu_torch.opt.nsga2 import Nsga2
from limbo_tpu_torch.ops.ehvi import ehvi_max
from limbo_tpu_torch.ops.pareto import non_dominated_mask
from limbo_tpu_torch.utils.device import resolve_device

FRONT_CAP = 64

# What the last Ehvi.iterate did (read by benchmarks and tests, like
# ops/_cuda.LAUNCHES): the observed front's size and the rows it was held
# at, the boxes of the exact EHVI's decomposition per candidate
# ((front_cap + 1)^(p - 1)), the seeds the ascent climbed and its steps,
# and whether its ascent captured a new CUDA graph (1) or not (0).
COUNTERS = {"front": 0, "front_cap": 0, "boxes": 0, "seeds": 0,
            "ascent_steps": 0, "captured": 0}


@dataclass
class _Iteration:
    """What a stop criterion reads of a multi-objective loop."""

    iteration: int


class BoMulti:
    """Shared machinery of the multi-objective loops (limbo BoMulti)."""

    def __init__(self, n_objs: int, kernel=None, mean=None, init=None,
                 stop: Sequence = None, nsga2: Optional[Nsga2] = None,
                 stats_enabled: bool = False, stats: Sequence = (),
                 res_base_dir: Optional[str] = None, dtype=torch.float64,
                 device="cuda"):
        self.device = resolve_device(device)
        self.n_objs = n_objs
        kw = dict(dtype=dtype, device=self.device)
        self.kernel = (kernel if kernel is not None
                       else MaternFiveHalves.create(**kw))
        self.mean = mean if mean is not None else NullMean(dim_out=n_objs)
        self.init = init if init is not None else RandomSampling(10)
        self.stop = tuple(stop) if stop is not None else (MaxIterations(30),)
        self.nsga2 = nsga2 if nsga2 is not None else Nsga2(pop_size=64,
                                                           generations=30)
        self.dtype = dtype
        self.stats_enabled = stats_enabled
        self.stats = tuple(stats)
        from limbo_tpu_torch.utils.sysinfo import make_res_dir
        self.res_dir = (make_res_dir(res_base_dir)
                        if (stats_enabled and res_base_dir is not None
                            and stats) else None)
        self.model: Optional[multi_gp.MultiGP] = None
        self.X: list = []
        self.Y: list = []
        self.iteration = 0

    # -- data handling -------------------------------------------------------

    def _eval_checked(self, f, x: np.ndarray) -> np.ndarray:
        y = np.atleast_1d(np.asarray(f(x), dtype=np.float64))
        if not np.all(np.isfinite(y)):
            raise EvaluationError(f"invalid observation {y} at {x}")
        return y

    def _generator(self, generator) -> torch.Generator:
        if generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(0)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def add_sample(self, x, y):
        self.X.append(np.asarray(x))
        self.Y.append(np.asarray(y))

    def update_models(self, capacity: Optional[int] = None):
        """Refit one GP per objective (bo_multi.hpp _update_models)."""
        self.model = multi_gp.fit(self.kernel, self.mean,
                                  self._tensor(np.stack(self.X)),
                                  self._tensor(np.stack(self.Y)),
                                  capacity=capacity, device=self.device,
                                  dtype=self.dtype)

    def pareto_data(self) -> Tuple[np.ndarray, np.ndarray]:
        """The non-dominated observed points (bo_multi.hpp
        update_pareto_data)."""
        Y = np.stack(self.Y)
        nd = non_dominated_mask(self._tensor(Y)).cpu().numpy()
        return np.stack(self.X)[nd], Y[nd]

    def pareto_model(self, generator: torch.Generator
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """NSGA-II over the posterior means -> the model front (x, mu,
        sigma^2) (bo_multi.hpp update_pareto_model:184)."""
        model = self.model

        def objs(X):
            with torch.no_grad():
                return multi_gp.query(model, X)[0]

        Xp, Yp = self.nsga2(objs, int(model.dim_in), generator,
                            dtype=self.dtype)
        with torch.no_grad():
            nd = non_dominated_mask(Yp)
            mu, var = multi_gp.query(model, Xp)
        nd = nd.cpu().numpy()
        return (Xp.cpu().numpy()[nd], mu.cpu().numpy()[nd],
                var.cpu().numpy()[nd])

    def _init_design(self, f, dim: int, generator):
        X0 = self.init(generator, dim, dtype=self.dtype).cpu().numpy()
        for x in X0:
            self.add_sample(x, self._eval_checked(f, x))

    def _stopped(self) -> bool:
        state = _Iteration(self.iteration)
        return any(bool(s(state)) for s in self.stop)

    def _update_stats(self):
        if not self.stats_enabled:
            return
        for stat in self.stats:
            stat(self)


class _CapturedAscent:
    """``Ehvi.step`` as CUDA graphs (bo/graph.py ``Captured``), one per
    front bucket.  The graphs read a copy of the model at fixed addresses,
    which every call overwrites in place with the refitted model
    (``assign_gp``; a new capacity or input width starts over), and copies
    of the front and the seeds.  On a card a bucket's first call runs the
    ascent eagerly, captures it and replays it; later calls replay and
    return copies of the graph's proposal and value.  As in every capture,
    the inner optimizer must not wait on the card (the warm-up raises where
    it does) and draws only from the generator it is handed (None here:
    the device's default one).  On another device every call runs the
    ascent eagerly over the same copies."""

    def __init__(self, step: Callable):
        self.step = step
        self.model = None
        self.graphs = {}    # front rows -> (Captured, inputs, outputs)

    def _assign(self, model) -> bool:
        """Copy ``model`` into the graphs' model in place; False (and a new
        copy) where the two differ in shape."""
        own = self.model
        if own is not None and len(own.gps) == len(model.gps) and all(
                a.x.shape == b.x.shape for a, b in zip(own.gps, model.gps)):
            assign_gp(own, model)
            return True
        self.model = copy.deepcopy(model)
        return False

    def __call__(self, model, front_y, front_mask, seeds):
        if not self._assign(model):
            self.graphs = {}
        inputs = (front_y, front_mask, seeds)
        entry = self.graphs.get(front_y.shape[0])
        fresh = entry is None
        if fresh:
            own, outputs = tuple(t.clone() for t in inputs), []

            def body():
                outputs[:] = self.step(self.model, *own)
            entry = (Captured({None: body}, None, front_y.device), own,
                     outputs)
            self.graphs[front_y.shape[0]] = entry
        else:
            for t, u in zip(entry[1], inputs):
                t.copy_(u)
        graphs, _, outputs = entry
        graphs.run(None)
        captured = fresh and graphs.graphs is not None
        if captured:
            graphs.run(None)    # the first run warmed up and captured
        COUNTERS["captured"] = int(captured)
        return tuple(t.clone() for t in outputs)


class Ehvi(BoMulti):
    """Expected-hypervolume-improvement BO (limbo Ehvi, ehvi.hpp:82).

    2 or 3 objectives (n_objs = len(ref)): the exact EHVI by box
    decomposition (ops/ehvi.py).  q > 1 proposes a q-point batch an
    iteration by maximizing the exact joint q-EHVI
    (ops/ehvi.qehvi_exact_max with the joint posterior of
    acqui/qei.joint_posterior_multi); meant for q <= 4."""

    def __init__(self, ref: Sequence[float] = (0.0, 0.0),
                 inner_opt=None, q: int = 1, gh_nodes: int = 12, **kw):
        super().__init__(n_objs=len(ref), **kw)
        self.ref = np.asarray(ref, dtype=np.float64)
        self.inner_opt = (inner_opt if inner_opt is not None
                          else Rprop(iterations=50))
        self.q = int(q)
        self.gh_nodes = int(gh_nodes)
        self._ref = self._tensor(self.ref)
        self._captured = None

    def acquisition(self, model, front_y: torch.Tensor,
                    front_mask: torch.Tensor) -> Callable:
        """The acquisition the ascent climbs: (R, q d) seeds -> (R,); EHVI
        at q = 1, the exact q-EHVI of each (q, d) batch otherwise."""
        ref = self._ref
        d = model.dim_in
        if self.q == 1:
            def acq(X):
                mu, var = multi_gp.query(model, X)
                sigma = torch.sqrt(torch.clamp(var, min=1e-20))
                return ehvi_max(mu, sigma, front_y, ref,
                                front_mask=front_mask)
            return acq

        from limbo_tpu_torch.acqui.qei import joint_posterior_multi
        from limbo_tpu_torch.ops.ehvi import qehvi_exact_max

        def acq(flat):
            mu, cov = joint_posterior_multi(model, flat.reshape(-1, self.q,
                                                                d))
            return qehvi_exact_max(mu, cov, front_y, ref,
                                   front_mask=front_mask,
                                   gh_nodes=self.gh_nodes)
        return acq

    def seeds(self, front_x: torch.Tensor, generator: torch.Generator
              ) -> torch.Tensor:
        """The ascent's starts: the front points at q = 1; at q > 1 each
        front point tiled to q copies moved by 0.1 N(0, 1), clipped to the
        box, as (F, q d)."""
        if self.q == 1:
            return front_x
        F, d = front_x.shape
        eps = torch.randn((F, self.q, d), generator=generator,
                          dtype=front_x.dtype, device=front_x.device)
        return self.seeds_from(front_x, eps)

    def seeds_from(self, front_x: torch.Tensor, eps: torch.Tensor
                   ) -> torch.Tensor:
        """The q > 1 seeds given their normals eps (F, q, d)."""
        F, d = front_x.shape
        seeds = front_x[:, None, :].expand(F, self.q, d) + 0.1 * eps
        return torch.clamp(seeds, 0.0, 1.0).reshape(F, self.q * d)

    def step(self, model, front_y, front_mask, seeds
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One batched ascent of every seed; the best valid one's point
        ((d,), or (q, d) at q > 1) and value, on the device."""
        res = self.inner_opt(self.acquisition(model, front_y, front_mask),
                             seeds, None, True)
        value = torch.where(front_mask > 0, res.value,
                            torch.full_like(res.value, -torch.inf))
        i = torch.argmax(value)
        x = take(res.x, i)
        return (x if self.q == 1 else x.reshape(self.q, model.dim_in),
                take(value, i))

    def padded_front(self, dim: int):
        """The observed front, whole: (x, y, mask) on the device, padded to
        FRONT_CAP * ceil(k / FRONT_CAP) rows (FRONT_CAP at least) for a
        front of k points.  limbo climbs the EHVI over the whole observed
        front from every Pareto point (ehvi.hpp:128-147); the buckets keep
        the ascent's shapes fixed while the front stays inside one."""
        Xp, Yp = self.pareto_data()
        k = len(Xp)
        cap = FRONT_CAP * max(1, -(-k // FRONT_CAP))
        fx = np.zeros((cap, dim))
        fx[:k] = Xp
        fy = np.tile(self.ref, (cap, 1))
        fy[:k] = Yp
        fm = np.zeros(cap)
        fm[:k] = 1.0
        COUNTERS.update(front=k, front_cap=cap)
        return self._tensor(fx), self._tensor(fy), self._tensor(fm)

    def iterate(self, f: Callable, dim: int, generator: torch.Generator,
                capacity: int):
        """One iteration of the loop (ehvi.hpp:82): refit one GP per
        objective at ``capacity`` rows, take the observed front, climb the
        EHVI from every Pareto point, evaluate the proposal with ``f`` and
        append it.  Returns the proposal ((d,), or (q, d) at q > 1) on the
        host and its EHVI value on the device.  The phases are the
        torch.profiler spans mo.refit, mo.front, mo.ascent (which ends on
        the host's read of the proposal) and mo.eval.  At q = 1 the ascent
        is ``step`` as CUDA graphs (``_CapturedAscent``), over a copy of the
        model, ``ascent_model``."""
        with record_function("mo.refit"):
            self.update_models(capacity=capacity)
        with record_function("mo.front"):
            fx, fy, fm = self.padded_front(dim)
        cap = fx.shape[0]
        COUNTERS.update(boxes=(cap + 1) ** (self.n_objs - 1), seeds=cap,
                        ascent_steps=getattr(self.inner_opt, "iterations",
                                             0))
        with record_function("mo.ascent"):
            x_new, value = self._ascent()(self.model, fy, fm,
                                          self.seeds(fx, generator))
            x_new = x_new.cpu().numpy()
        with record_function("mo.eval"):
            for x in (x_new[None, :] if self.q == 1 else x_new):
                self.add_sample(x, self._eval_checked(f, x))
        self.iteration += 1
        self._update_stats()
        return x_new, value

    def _ascent(self) -> Callable:
        """``step`` as CUDA graphs, or ``step`` itself at q > 1 (the q-EHVI
        copies its Gauss-Hermite grid from the host inside the step, which
        a capture cannot hold)."""
        if self.q != 1:
            COUNTERS["captured"] = 0
            return self.step
        if self._captured is None:
            self._captured = _CapturedAscent(self.step)
        return self._captured

    @property
    def ascent_model(self):
        """The model the last ascent climbed: at q = 1 the graphs' copy of
        the refitted model, else the model itself."""
        return self.model if self._captured is None else self._captured.model

    def optimize(self, f: Callable, dim: int,
                 generator: Optional[torch.Generator] = None,
                 reset: bool = True):
        gen = self._generator(generator)
        if reset:
            self.X, self.Y, self.iteration = [], [], 0
            self._init_design(f, dim, gen)
        cap = max(64, -(-(len(self.X) + self._max_iters() * self.q)
                        // 64) * 64)
        while not self._stopped():
            self.iterate(f, dim, gen, cap)
        self.update_models(capacity=cap)
        return self.pareto_data()

    def _max_iters(self) -> int:
        for s in self.stop:
            if isinstance(s, MaxIterations):
                return s.iterations
        return 30


class Nsbo(BoMulti):
    """Pareto-front-of-variances sampling (limbo Nsbo, nsbo.hpp:65)."""

    def optimize(self, f: Callable, dim: int,
                 generator: Optional[torch.Generator] = None,
                 reset: bool = True):
        gen = self._generator(generator)
        if reset:
            self.X, self.Y, self.iteration = [], [], 0
            self._init_design(f, dim, gen)
        while not self._stopped():
            self.update_models()
            Xp, mu_p, var_p = self.pareto_model(gen)
            # the Pareto front of the VARIANCES (nsbo.hpp:82)
            nd = non_dominated_mask(torch.as_tensor(var_p)).numpy()
            cand = Xp[nd]
            idx = int(torch.randint(0, len(cand), (), generator=gen,
                                    device=gen.device))
            x_new = cand[idx]
            self.add_sample(x_new, self._eval_checked(f, x_new))
            self.iteration += 1
            self._update_stats()
        self.update_models()
        return self.pareto_data()


class Parego:
    """Multi-objective BO by Chebyshev scalarization to a single-objective
    BOptimizer (limbo Parego + GPParego).

    Each outer iteration draws fresh weights l ~ normalized U(0,1)^M,
    scalarizes ALL observations, s(y) = max_j(l_j y_j) + rho sum_j l_j y_j
    (gp_parego.hpp:103-116; rho = 0.05), fits a GP to s and takes one
    acquisition step of ``bo`` (its ``_maximize``) on it."""

    def __init__(self, n_objs: int, rho: float = 0.05, bo: BOptimizer = None,
                 iterations: int = 30, init=None, dtype=torch.float64,
                 device="cuda"):
        self.device = resolve_device(device)
        self.n_objs = n_objs
        self.rho = rho
        self.iterations = iterations
        self.init = init if init is not None else RandomSampling(10)
        self.dtype = dtype
        self.bo = bo if bo is not None else BOptimizer(
            stats_enabled=False, dtype=dtype,
            stop=(MaxIterations(iterations),), device=self.device)
        self.X: list = []
        self.Y: list = []

    def _scalarize(self, Y: np.ndarray, lam: np.ndarray) -> np.ndarray:
        w = Y * lam[None, :]
        return (w.max(axis=1) + self.rho * w.sum(axis=1))[:, None]

    def optimize(self, f: Callable, dim: int,
                 generator: Optional[torch.Generator] = None):
        gen = (generator if generator is not None
               else torch.Generator(device=self.device).manual_seed(0))
        X0 = self.init(gen, dim, dtype=self.dtype).cpu().numpy()
        for x in X0:
            y = np.atleast_1d(np.asarray(f(x), dtype=np.float64))
            self.X.append(x)
            self.Y.append(y)

        capacity = max(64, -(-(len(self.X) + self.iterations + 1) // 64) * 64)
        kw = dict(dtype=self.dtype, device=self.device)
        kern = (self.bo.kernel if self.bo.kernel is not None
                else MaternFiveHalves.create(**kw))
        for it in range(self.iterations):
            lam = torch.rand((self.n_objs,), generator=gen, device=gen.device,
                             dtype=torch.float64).cpu().numpy()
            lam = lam / lam.sum()
            S = self._scalarize(np.stack(self.Y), lam)
            mean = (self.bo.mean if self.bo.mean is not None
                    else DataMean.create(dim_out=1, **kw))
            gp = gp_mod.fit(kern, mean, np.stack(self.X), S,
                            capacity=capacity, **kw)
            x_new = self.bo._maximize(gp, it, gen).x.cpu().numpy()
            y = np.atleast_1d(np.asarray(f(x_new), dtype=np.float64))
            if not np.all(np.isfinite(y)):
                raise EvaluationError(f"invalid observation {y}")
            self.X.append(x_new)
            self.Y.append(y)

        Y = np.stack(self.Y)
        nd = non_dominated_mask(torch.as_tensor(Y)).numpy()
        return np.stack(self.X)[nd], Y[nd]
