"""Hyperparameter learning, repeated: KernelLFOpt over ParallelRepeater(
Rprop(iterations), repeats) (``bo.default_hp_opt(iterations, repeats)``),
each learning from the fitted GP with fresh draws, ending in its refit.

The window's unit is one learning.  Each LML (and LML + gradient)
evaluation the learning makes is recorded as it happens (a thin wrapper
around Rprop keeps the point, the value and, from a hook on the point, the
gradient Rprop takes), so the check reads what the timed path computed.

The check compares, against the float64 reference of the generated data:
the LML and its gradient at a sample of the last learning's evaluations
(the last one with a gradient, and two more drawn from the seed), and the
returned GP's L and alpha at the parameters it returned.
"""

from __future__ import annotations

import random

import torch

from perfbench import gpdata
from perfbench.reference import control, gp64

SAMPLE = 2           # graded evaluations compared besides the last one


class _Recorded:
    """Rprop (or any sub-optimizer) whose objective calls are recorded."""

    def __init__(self, sub):
        self.sub = sub
        self.evals: list = []

    def __call__(self, fun, x0, generator=None, bounded=False):
        evals = self.evals

        def recorded(X):
            v = fun(X)
            e = {"x": X.detach().clone(), "v": v.detach().clone(), "g": None}
            if X.requires_grad:
                X.register_hook(lambda g, e=e: e.__setitem__(
                    "g", g.detach().clone()))
            evals.append(e)
            return v

        return self.sub(recorded, x0, generator, bounded)


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from limbo_tpu_torch.models.hp_opt import KernelLFOpt
        from limbo_tpu_torch.opt import ParallelRepeater, Rprop

        self.cfg = cfg
        self.dev = torch.device(device)
        self.d = cfg["dim"]
        self.trace_after = traffic["trace_after"]
        self.trace_units = traffic["trace_units"]
        hp = cfg["hp_opt"]
        self.gen, self.X, self.Y = gpdata.make_data(cfg, seed, self.dev)
        kernel, mean = gpdata.make_model(cfg, self.dev)
        self.gp0 = gpdata.fit(cfg, kernel, mean, self.X, self.Y, self.dev)
        self.rec = _Recorded(Rprop(iterations=hp["iterations"]))
        self.strategy = KernelLFOpt(optimizer=ParallelRepeater(
            sub=self.rec, repeats=hp["repeats"]))
        self.last = None

    def sync(self) -> None:
        gpdata.sync(self.dev)

    def warm(self) -> None:
        """One LML + gradient at the fitted parameters and one refit: every
        shape a learning runs."""
        from limbo_tpu_torch.models import gp as gp_mod

        gp = self.gp0
        p = gp.kernel.params.clone().requires_grad_(True)
        v = gp_mod.log_marginal_likelihood(gp.kernel.with_params(p), gp.mean,
                                           gp.x, gp.y, gp.n)
        torch.autograd.grad(v, p)
        gp_mod.recompute(gp)
        self.sync()

    def unit(self) -> dict:
        self.last = None
        self.rec.evals = []
        gp = self.strategy(self.gp0, self.gen)
        self.sync()
        self.last = gp
        ev = self.rec.evals
        graded = sum(e["g"] is not None for e in ev)
        return {"graded": graded, "values": len(ev) - graded,
                "failed": not bool(torch.isfinite(gp.alpha).all())}

    # -- the check ---------------------------------------------------------

    def settle(self) -> None:
        """Nothing to carry on: the window's last unit ran to its end."""

    def free(self) -> None:
        self.gp0 = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def drop(self) -> None:
        """Release the program's state (after ``check``)."""
        self.last = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self, seed: int) -> list:
        graded = [i for i, e in enumerate(self.rec.evals)
                  if e["g"] is not None]
        pick = random.Random(seed).sample(graded[:-1],
                                          min(SAMPLE, len(graded) - 1))
        return sorted(set(pick) | {graded[-1]})

    def _theta(self, p: torch.Tensor) -> torch.Tensor:
        return p.reshape(-1).detach().double().cpu()

    def check(self, seed: int) -> dict:
        gp = self.last
        n, noise = gp.n, self.cfg["noise"]
        X, Y = self.X.double(), self.Y.double()
        lml = grad = 0.0
        self.picked = self._sample(seed)
        for i in self.picked:
            e = self.rec.evals[i]
            v64, g64, vpart, gpart = gp64.lml_grad(X, Y, self._theta(e["x"]),
                                                   noise)
            lml = max(lml, abs(float(e["v"].reshape(())) - v64) / vpart)
            g = self._theta(e["g"])
            grad = max(grad, float(((g - g64).abs() / gpart).max()))
        self.theta_ret = gpdata.program_theta(gp.kernel)
        ref = gp64.State(X, Y, self.theta_ret, noise, inverse=False)
        out = {"lml": lml, "lml_grad": grad,
               "L": gp64.rel_max(gp.L[:n, :n], ref.L),
               "alpha": gp64.rel_max(gp.alpha[:n], ref.alpha)}
        return out

    def control(self, seed: int) -> dict:
        """The control's readings: the same LMLs, gradients, L and alpha
        computed in TF32."""
        noise = self.cfg["noise"]
        X, Y = self.X.double(), self.Y.double()
        lml = grad = 0.0
        for i in self.picked:
            th = self._theta(self.rec.evals[i]["x"])
            v64, g64, vpart, gpart = gp64.lml_grad(X, Y, th, noise)
            vc, gc = control.lml_grad(X, Y, th, noise)
            lml = max(lml, abs(vc - v64) / vpart)
            grad = max(grad, float(((gc - g64).abs() / gpart).max()))
        ref = gp64.State(X, Y, self.theta_ret, noise, inverse=False)
        cs = control.State(X, Y, self.theta_ret, noise)
        return {"lml": lml, "lml_grad": grad,
                "L": gp64.rel_max(cs.L, ref.L),
                "alpha": gp64.rel_max(cs.alpha, ref.alpha)}
