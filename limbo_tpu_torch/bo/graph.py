"""The captured BO iteration: one iteration of the loop as a CUDA graph
(the counterpart of the reference's jitted ``live_step``,
limbo_tpu/bo/optimizer.py:680-718, and of bench.py's donated ``bo_iter``,
bench.py:106-120).

An iteration of the port is ~1,900 small kernels launched from Python (the
acquisition's sweep, 20 ascent steps with their gradients, the append),
and the host's launches, not the card, set its pace.  ``BOStep``
runs one iteration over a GP (and its K^{-1} cache) held in place, and on a
CUDA device records it once as a CUDA graph and replays it:

* **State at fixed addresses.**  A graph replays the addresses it saw, so
  every tensor that lives across iterations is the step's own and is only
  ever written in place: the appends write their rows at the device counts
  (``GP.n_dev``, ``QueryCache.base_n_dev``), and what they return as new
  tensors (alpha, the mean, ``ay``, ``u_ones``, the counts) is copied into
  the step's tensors at the end of the step (``_write_back``).  A rebuild
  between replays (a refit, the hp cadence) copies in the same way
  (``BOStep.assign``), with no new capture.
* **Two graphs in one memory pool** for the "deferred" append: the
  iteration without and with the flush of the pending pivots (for a lite
  cache with a bf16 mirror, the flush rebuilds the mirror from Linv panel
  by panel, in place, inside its graph).  The host knows the flush cadence
  from its own counts (one append an iteration) and replays one or the
  other; it never reads a count from the card.  The immediate appends
  ("refined", True, "linv", the solve) are one graph.
* **Draws.**  A draw captured in a graph would repeat its numbers at every
  replay.  Every draw of the step from the run's ``torch.Generator`` (the
  sweep, random starts) is made instead, before each replay, into a static
  buffer that the graph reads, by the same calls in the same order as the
  step makes them eagerly (``_Draws``): a captured run sees the draws of
  the eager run with the same generator.
* **Warm-up.**  The first iteration runs eagerly on a side stream (the rule
  of ``torch.cuda.graph``), with ``torch.cuda.set_sync_debug_mode("error")``
  so that a step that waits on the card (``.item()``, ``bool()``, a copy to
  the host) raises; it also runs the kernels' one-time set-up (the
  launchers' shared-memory opt-in and tensor-map encoder lookup, the
  mirror's launch plan) outside the capture.  A capture that fails raises:
  the step never falls back to running eagerly on a card.
* **Garbage.**  A step and its functions form a reference cycle, so an
  earlier run's graphs may wait for the cyclic collector; the capture
  collects first and holds the collector off while it runs, since a graph
  destroyed during a capture invalidates it.
* **Launch counts.**  ``ops/_cuda.LAUNCHES`` counts the wrappers' calls,
  and a replay calls none: each graph's counts are taken at its capture
  (and taken back out, since a capture launches nothing) and added at
  every replay.

On the CPU (the tests) the same step runs eagerly: the caller asked for
the CPU.
"""

from __future__ import annotations

import copy
import gc
import time
from typing import Callable, Optional

import torch
from torch.overrides import TorchFunctionMode

from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.ops import _cuda


class _Draws(TorchFunctionMode):
    """Every draw from ``generator`` inside a step.  Recording (no buffers),
    each draw is made and its call noted; with ``buffers``, the step is
    being captured and each draw returns the next static buffer, which
    ``refill`` fills before a replay by the noted calls, in order."""

    def __init__(self, generator, calls=None, buffers=None):
        super().__init__()
        self.generator = generator
        self.calls = [] if calls is None else calls
        self.buffers = buffers
        self.results = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        g = kwargs.get("generator")
        if g is None:
            return func(*args, **kwargs)
        if g is not self.generator or any(torch.is_tensor(a) for a in args):
            raise RuntimeError(
                f"a captured BO step draws through {func.__name__} from "
                "another generator or into an existing tensor; draw with "
                "torch.rand/randn/randperm(..., generator=<the run's "
                "generator>)")
        if self.buffers is None:
            out = func(*args, **kwargs)
            self.calls.append((func, args, kwargs))
            self.results.append(out)
            return out
        k = len(self.results)
        if k >= len(self.calls) or self.calls[k] != (func, args, kwargs):
            raise RuntimeError("a captured BO step drew other numbers than "
                               "its warm-up did")
        self.results.append(self.buffers[k])
        return self.buffers[k]

    def refill(self) -> None:
        for (func, args, kwargs), buf in zip(self.calls, self.buffers):
            buf.copy_(func(*args, **kwargs))


class Captured:
    """Functions of no arguments, ``fns[key]()``, run as CUDA graphs on a
    CUDA device: the first ``run`` runs its function eagerly (the warm-up)
    and then captures every function into one memory pool; each later
    ``run`` refills the draws and replays.  The functions must make the
    same draws in the same order (they are variants of one step).  On
    another device ``run`` calls the function."""

    def __init__(self, fns: dict, generator, device: torch.device):
        self.fns, self.generator, self.device = fns, generator, device
        self.graphs = None          # key -> (CUDAGraph, launch counts)
        self.draws = None           # the _Draws of the captures
        self.setup_s = 0.0          # the warm-up and capture, host clock

    def run(self, key) -> None:
        if self.device.type != "cuda":
            self.fns[key]()
            return
        if self.graphs is None:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            self._warm_up(key)
            self._capture()
            torch.cuda.synchronize(self.device)
            self.setup_s = time.perf_counter() - t0
            return
        graph, counts = self.graphs[key]
        self.draws.refill()
        graph.replay()
        for k, c in counts.items():
            _cuda.LAUNCHES[k] += c

    def _warm_up(self, key) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        record = _Draws(self.generator)
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.stream(side):
                torch.cuda.set_sync_debug_mode("error")
                with record:
                    self.fns[key]()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        main.wait_stream(side)
        self.draws = _Draws(self.generator, record.calls,
                            [torch.empty_like(r) for r in record.results])

    def _capture(self) -> None:
        # A garbage cycle can hold an earlier run's graph (a step and the
        # functions it captures refer to each other), and destroying a
        # graph is not permitted while a capture is under way: collect
        # before the capture, and let no collection run during it (one can
        # start at any allocation of a Python object).
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            self._capture_all()
        finally:
            if enabled:
                gc.enable()

    def _capture_all(self) -> None:
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        for key, fn in self.fns.items():
            graph = torch.cuda.CUDAGraph()
            before = dict(_cuda.LAUNCHES)
            self.draws.results = []
            try:
                with torch.cuda.graph(graph, pool=pool):
                    with self.draws:
                        fn()
            finally:
                counts = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
                _cuda.LAUNCHES.update(before)
            if len(self.draws.results) != len(self.draws.calls):
                raise RuntimeError("a captured BO step drew other numbers "
                                   "than its warm-up did")
            graphs[key] = (graph, {k: c for k, c in counts.items() if c})
        self.graphs = graphs


def _copy_buffers(dst, src) -> None:
    """Copy src's hyperparameter tensors into dst's (modules of one
    class), in place."""
    if dst is src:
        return
    for (a, t), (b, u) in zip(dst.named_buffers(), src.named_buffers()):
        if a != b:
            raise ValueError(f"module buffers differ: {a} and {b}")
        if t is not u:
            t.copy_(u)


def _write_back(dst, src, fields) -> None:
    """Copy the named tensor fields of src into dst's, in place (fields
    src shares with dst are skipped)."""
    for name in fields:
        t, u = getattr(dst, name), getattr(src, name)
        if (t is None) != (u is None):
            raise ValueError(f"{name}: one side has no tensor")
        if t is not None and t is not u:
            t.copy_(u)


_GP_FIELDS = ("x", "y", "L", "alpha", "n_dev")
_CACHE_FIELDS = ("Kinv", "K", "Linv", "Kinv_q", "P", "ay", "u_ones",
                 "base_n_dev")


class BOStep:
    """One BO iteration over a GP (and its K^{-1} cache) held in place:
    ``x = propose(model, it)`` (the model is the GP, or its CachedGPView,
    and ``it`` the iteration count as a 0-d int64 tensor on the device),
    ``y = objective(x)``, then the append (``add_sample_cached`` with
    ``fast_update``, or the exact ``add_sample``), then
    ``on_sample(it, x, y)`` if given (e.g. writing a history row at ``it``).
    ``propose``, ``objective`` and ``on_sample`` must be torch code on the
    device that never waits on the card.

    The step takes the GP and cache as its own: it copies their kernel and
    mean modules and counts, and writes every other tensor in place.  On a
    CUDA device the first ``step()`` runs eagerly and captures, later ones
    replay; ``step(eager=True)`` runs the same step eagerly on the same
    state (the uncaptured iteration), as every step runs on the CPU.  The
    exact append's finiteness flag is read after each step, and a bad
    append refits eagerly (``add_sample``'s retry): that path reads the card
    once an iteration.
    """

    def __init__(self, gp: gp_mod.GP, cache: Optional[gp_mod.QueryCache],
                 propose: Callable, objective: Callable, generator,
                 fast_update=False, on_sample: Optional[Callable] = None):
        self.gp = gp.replace(kernel=copy.deepcopy(gp.kernel),
                             mean=copy.deepcopy(gp.mean),
                             n_dev=gp.n_dev.clone())
        self.cache = (cache.replace(base_n_dev=cache.base_n_dev.clone())
                      if cache is not None and cache.base_n_dev is not None
                      else cache)
        self.propose, self.objective = propose, objective
        self.fast_update, self.on_sample = fast_update, on_sample
        dev = gp.x.device
        self.it = torch.zeros((), dtype=torch.int64, device=dev)
        self.ok = torch.ones((), dtype=torch.bool, device=dev)
        self.deferred = cache is not None and fast_update == "deferred"
        keys = (False, True) if self.deferred else (None,)
        self.graphs = Captured({k: (lambda k=k: self._body(k)) for k in keys},
                               generator, dev)

    @property
    def model(self):
        return (gp_mod.CachedGPView(self.gp, self.cache)
                if self.cache is not None else self.gp)

    def _body(self, flush) -> None:
        gp, cache = self.gp, self.cache
        x = self.propose(self.model, self.it)
        y = self.objective(x).to(gp.x.dtype).reshape(gp.dim_out)
        if cache is None:
            gp2, ok = gp_mod.add_sample_ok(gp, x, y)
            self.ok.copy_(ok)
        else:
            gp2, cache2 = gp_mod.add_sample_cached(
                gp, cache, x, y, fast_update=self.fast_update, flush=flush)
            _write_back(cache, cache2, _CACHE_FIELDS)
        if self.on_sample is not None:
            self.on_sample(self.it, x, y)
        self.it.add_(1)
        _write_back(gp, gp2, _GP_FIELDS)
        _copy_buffers(gp.mean, gp2.mean)

    def step(self, eager: bool = False, flush: Optional[bool] = None
             ) -> None:
        """Run one iteration (replayed, or eagerly with ``eager``) and
        advance the host counts.  ``flush`` forces the deferred append's
        flush on (its graph) or off; by default the host's counts decide."""
        gp = self.gp
        if gp.n >= gp.capacity:
            raise ValueError(f"GP is full (capacity {gp.capacity})")
        # the deferred append's flush by the host's counts (one append an
        # iteration), None for the other appends
        if not self.deferred:
            flush = None
        elif flush is None:
            flush = (gp.n - self.cache.base_n) + 1 >= self.cache.P.shape[1]
        if eager:
            self._body(flush)
        else:
            self.graphs.run(flush)
        gp.n += 1
        if flush:
            self.cache.base_n = gp.n
        if self.cache is None and not bool(self.ok):
            self.assign(gp_mod.recompute(gp))

    def assign(self, gp: gp_mod.GP,
               cache: Optional[gp_mod.QueryCache] = None) -> None:
        """Make ``gp`` (and ``cache``) the step's state by copying them into
        the step's tensors, in place (a refit, a rebuild, hp-opt between
        replays)."""
        _write_back(self.gp, gp, _GP_FIELDS)
        _copy_buffers(self.gp.kernel, gp.kernel)
        _copy_buffers(self.gp.mean, gp.mean)
        self.gp.n = gp.n
        if cache is not None:
            _write_back(self.cache, cache, _CACHE_FIELDS)
            self.cache.base_n = cache.base_n

    def launches(self) -> dict:
        """Kernel launches of one replay, by graph (flush or not)."""
        graphs = self.graphs.graphs or {}
        return {k: dict(counts) for k, (_, counts) in graphs.items()}
