"""The refit of a large GP and the rebuild of its query cache, repeated:
what the hp cadence does after each learning, and what a resumed run pays.

A unit is ``recompute`` (the training covariance, the blocked Cholesky,
alpha) of the configuration's data at new kernel parameters, then
``QueryCache.build`` of the configuration's cache.  The new parameters are
the configuration's log length-scales each moved by U(-move, move), drawn
from the seed's generator for every refit, so no result can be reused.

The check compares the last refit's L, Linv, alpha and the mirror with the
float64 reference at the parameters that refit took.
"""

from __future__ import annotations

import torch

from perfbench import gpdata
from perfbench.reference import control, gp64


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg = cfg
        self.dev = torch.device(device)
        self.d = cfg["dim"]
        self.move = traffic["log_ell_move"]
        self.trace_after = traffic["trace_after"]
        self.trace_units = traffic["trace_units"]
        self.gen, self.X, self.Y = gpdata.make_data(cfg, seed, self.dev)
        kernel, mean = gpdata.make_model(cfg, self.dev)
        gp = gpdata.fit(cfg, kernel, mean, self.X, self.Y, self.dev)
        # the data and the model without a factor: every refit makes its own
        self.base = gp.replace(L=torch.empty(0, device=self.dev),
                               alpha=torch.empty(0, device=self.dev))
        self.state = (gp, gpdata.build(cfg, gp))
        self.log_ell0 = kernel.log_ell.clone()

    def sync(self) -> None:
        gpdata.sync(self.dev)

    def warm(self) -> None:
        """The set-up's fit and build ran every shape; one refit more."""
        self.unit()

    def unit(self) -> dict:
        from limbo_tpu_torch.models import gp as gp_mod

        self.state = None
        u = torch.rand((self.d,), generator=self.gen, device=self.dev)
        log_ell = self.log_ell0 + (2.0 * u - 1.0) * self.move
        gp = gp_mod.recompute(self.base.replace(
            kernel=self.base.kernel.replace(log_ell=log_ell)))
        cache = gpdata.build(self.cfg, gp)
        self.sync()
        self.state = (gp, cache)
        return {"failed": not bool(torch.isfinite(gp.alpha).all())}

    # -- the check ---------------------------------------------------------

    def settle(self) -> None:
        """Nothing to carry on: the window's last unit ran to its end."""

    def free(self) -> None:
        self.base = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def drop(self) -> None:
        """Release the program's state (after ``check``)."""
        self.state = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, seed: int) -> dict:
        gp, cache = self.state
        n = gp.n
        self.theta = gpdata.program_theta(gp.kernel)
        ref = gp64.State(self.X.double(), self.Y.double(), self.theta,
                         self.cfg["noise"])
        out = {"L": gp64.rel_max(gp.L[:n, :n], ref.L),
               "Linv": gp64.rel_max(cache.Linv[:n, :n], ref.Linv),
               "alpha": gp64.rel_max(gp.alpha[:n], ref.alpha),
               "mirror": gp64.rel_max(cache.Kinv_q[:n, :n], ref.Kinv)}
        self.ref = ref
        return out

    def control(self, seed: int) -> dict:
        """The control's readings: L, Linv and alpha in TF32, the mirror in
        float8."""
        ref = self.ref
        cs = control.State(self.X.double(), self.Y.double(), self.theta,
                           self.cfg["noise"])
        out = {"L": gp64.rel_max(cs.L, ref.L),
               "Linv": gp64.rel_max(cs.Linv, ref.Linv),
               "alpha": gp64.rel_max(cs.alpha, ref.alpha)}
        del cs
        out["mirror"] = gp64.rel_max(control.fp8(ref.Kinv), ref.Kinv)
        return out
