"""Multi-objective statistics writers (port of limbo_tpu/bo/mo_stats.py).

Reference: src/limbo/experimental/stat/{hyper_volume,pareto_front,
pareto_benchmark}.hpp: the hypervolume of the observed Pareto front each
iteration (through the native hv code) and dumps of the fronts.  They
attach to the BoMulti-family loops (which expose .X / .Y / .iteration) and
use the native library (limbo_tpu_torch.native) on the host.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from limbo_tpu_torch.bo.stats import StatBase


class HyperVolume(StatBase):
    """experimental/stat/hyper_volume.hpp:63: the hypervolume of the
    observed front above ``ref``, one line per iteration."""

    filename = "hypervolume.dat"

    def __init__(self, ref):
        super().__init__()
        self.ref = np.asarray(ref, dtype=np.float64)

    def __call__(self, bo, state=None):
        from limbo_tpu_torch.native import filter_nondominated_host, hv_host

        Y = np.stack(bo.Y)
        keep = filter_nondominated_host(Y)
        hv = hv_host(Y[keep], self.ref)
        self._log(bo, f"{bo.iteration} {hv:.10g}")


class ParetoFront(StatBase):
    """experimental/stat/pareto_front.hpp: the current observed front, one
    file per iteration (pareto_front_<it>.dat, rows ``x... y...``)."""

    filename = "pareto_front.dat"

    def __call__(self, bo, state=None):
        if not bo.stats_enabled or getattr(bo, "res_dir", None) is None:
            return
        from limbo_tpu_torch.native import filter_nondominated_host

        X = np.stack(bo.X)
        Y = np.stack(bo.Y)
        keep = filter_nondominated_host(Y)
        path = os.path.join(bo.res_dir, f"pareto_front_{bo.iteration}.dat")
        np.savetxt(path, np.hstack([X[keep], Y[keep]]), fmt="%.10g")


class ParetoBenchmark(StatBase):
    """experimental/stat/pareto_benchmark.hpp: per iteration, the model
    front (predicted mu / sigma^2), its TRUE objective values (the
    benchmark function at the model front's points), the data front and
    every observation.  Files: pareto_model_<it>.dat,
    pareto_model_real_<it>.dat, pareto_data_<it>.dat, obs_<it>.dat.

    generator: the NSGA-II draws' torch.Generator (default: seeded with 17
    on the loop's device at the first call)."""

    def __init__(self, true_fn, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.true_fn = true_fn          # (d,) -> (M,) numpy callable
        self.generator = generator

    def __call__(self, bo, state=None):
        if not bo.stats_enabled or getattr(bo, "res_dir", None) is None:
            return
        if self.generator is None:
            self.generator = torch.Generator(device=bo.device).manual_seed(17)
        it = bo.iteration
        Xp, mu_p, var_p = bo.pareto_model(self.generator)
        np.savetxt(os.path.join(bo.res_dir, f"pareto_model_{it}.dat"),
                   np.hstack([mu_p, var_p]), fmt="%.10g")
        real = (np.stack([np.atleast_1d(self.true_fn(x)) for x in Xp])
                if len(Xp) else np.zeros((0, mu_p.shape[1])))
        np.savetxt(os.path.join(bo.res_dir, f"pareto_model_real_{it}.dat"),
                   real, fmt="%.10g")
        Xd, Yd = bo.pareto_data()
        np.savetxt(os.path.join(bo.res_dir, f"pareto_data_{it}.dat"), Yd,
                   fmt="%.10g")
        np.savetxt(os.path.join(bo.res_dir, f"obs_{it}.dat"),
                   np.hstack([np.stack(bo.Y), np.stack(bo.X)]), fmt="%.10g")
