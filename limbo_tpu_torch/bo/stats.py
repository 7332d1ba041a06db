"""Per-iteration statistics writers (port of limbo_tpu/bo/stats.py).

Reference: src/limbo/stat/ - 13 functors, each appending one line per
iteration to its own .dat file in the run's result dir, fired by
BoBase::_update_stats (bo_base.hpp:270).  A stat is a host-side callable
``stat(bo, state)`` that the driver invokes after each iteration with the
BOptimizer (for res_dir and stats_enabled) and the current BOState.  The
file names and line layouts are the reference's (whitespace-separated,
iteration first, ``%.10g``).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _aggregate(state, obs: np.ndarray) -> float:
    """The state's aggregator (batched, (q, p) -> (q,)) on one (p,)
    observation."""
    y = torch.as_tensor(np.ravel(obs))[None, :]
    return float(state.aggregator(y)[0])


def _fmt(values) -> str:
    return " ".join(f"{v:.10g}" for v in np.ravel(values))


class StatBase:
    """Per-stat log file (stat/stat_base.hpp:72-95), appended
    open-write-close once per host-loop iteration, so no file handle
    outlives a call."""

    filename = "stat.dat"

    def _log(self, bo, line: str):
        if not bo.stats_enabled or bo.res_dir is None:
            return
        with open(os.path.join(bo.res_dir, self.filename), "a") as fh:
            fh.write(line + "\n")

    def __call__(self, bo, state):
        raise NotImplementedError


class Samples(StatBase):
    """stat/samples.hpp:56 - last sample per iteration."""

    filename = "samples.dat"

    def __call__(self, bo, state):
        if state.last_sample is None:
            return
        self._log(bo, f"{state.iteration} {_fmt(state.last_sample)}")


class Observations(StatBase):
    """stat/observations.hpp:56 - last observation per iteration."""

    filename = "observations.dat"

    def __call__(self, bo, state):
        if state.last_observation is None:
            return
        self._log(bo, f"{state.iteration} {_fmt(state.last_observation)}")


class AggregatedObservations(StatBase):
    """stat/aggregated_observations.hpp:58."""

    filename = "aggregated_observations.dat"

    def __call__(self, bo, state):
        if state.last_observation is None:
            return
        agg = _aggregate(state, state.last_observation)
        self._log(bo, f"{state.iteration} {agg:.10g}")


class BestSamples(StatBase):
    """stat/best_samples.hpp:56."""

    filename = "best_samples.dat"

    def __call__(self, bo, state):
        self._log(bo, f"{state.iteration} {_fmt(state.best_sample)}")


class BestObservations(StatBase):
    """stat/best_observations.hpp:57."""

    filename = "best_observations.dat"

    def __call__(self, bo, state):
        self._log(bo, f"{state.iteration} {_fmt(state.best_observation)}")


class BestAggregatedObservations(StatBase):
    """stat/best_aggregated_observations.hpp:58."""

    filename = "best_aggregated_observations.dat"

    def __call__(self, bo, state):
        self._log(bo, f"{state.iteration} {state.best_value:.10g}")


class ConsoleSummary(StatBase):
    """stat/console_summary.hpp:56 - one line to stdout per iteration."""

    def __call__(self, bo, state):
        obs = (np.ravel(state.last_observation)
               if state.last_observation is not None else None)
        sample = (np.ravel(state.last_sample)
                  if state.last_sample is not None else "-")
        value = _aggregate(state, obs) if obs is not None else "-"
        print(f"{state.iteration} new point: {sample} value: {value}"
              f" best: {state.best_value:.6g}")


class GPLikelihood(StatBase):
    """stat/gp_likelihood.hpp:58 - model log-likelihood per iteration."""

    filename = "gp_likelihood.dat"

    def __call__(self, bo, state):
        from limbo_tpu_torch.models import gp as gp_mod

        ll = float(gp_mod.log_lik(state.gp))
        self._log(bo, f"{state.iteration} {ll:.10g}")


class GPKernelHParams(StatBase):
    """stat/gp_kernel_hparams.hpp:58 - kernel hyperparameters per
    iteration."""

    filename = "gp_kernel_hparams.dat"

    def __call__(self, bo, state):
        p = state.gp.kernel.params.detach().cpu().numpy()
        self._log(bo, f"{state.iteration} {_fmt(p)}")


class GPMeanHParams(StatBase):
    """stat/gp_mean_hparams.hpp:58."""

    filename = "gp_mean_hparams.dat"

    def __call__(self, bo, state):
        p = state.gp.mean.params.detach().cpu().numpy()
        self._log(bo, f"{state.iteration} {_fmt(p)}")


class GPGrid(StatBase):
    """stat/gp.hpp:58 - mu and sigma over a full grid each iteration.

    One file per iteration, gp_<iter>.dat, with rows ``x... mu... sigma``;
    the whole grid is one batched query.
    """

    filename = "gp.dat"

    def __init__(self, bins: int = 20):
        super().__init__()
        self.bins = bins

    def __call__(self, bo, state):
        if not bo.stats_enabled or bo.res_dir is None:
            return
        from limbo_tpu_torch.models import gp as gp_mod
        from limbo_tpu_torch.utils.random import grid_points

        X = grid_points(self.bins, state.gp.dim_in, dtype=state.gp.x.dtype,
                        device=state.gp.x.device)
        with torch.no_grad():
            mu, var = gp_mod.query(state.gp, X)
        arr = np.hstack([X.cpu().numpy(), mu.cpu().numpy(),
                         np.sqrt(var.cpu().numpy())[:, None]])
        path = os.path.join(bo.res_dir, f"gp_{state.iteration}.dat")
        np.savetxt(path, arr, fmt="%.10g")


class GPAcquisitions(StatBase):
    """stat/gp_acquisitions.hpp:58 - acquisition value at the chosen
    point."""

    filename = "gp_acquisitions.dat"

    def __call__(self, bo, state):
        if state.last_acqui_value is None:
            return
        self._log(bo, f"{state.iteration} "
                  f"{float(state.last_acqui_value):.10g}")


class GPPredictionDifferences(StatBase):
    """stat/gp_prediction_differences.hpp:58 - observation - prediction at
    the point chosen this iteration."""

    filename = "gp_prediction_differences.dat"

    def __call__(self, bo, state):
        if state.last_prediction is None or state.last_observation is None:
            return
        diff = np.ravel(np.asarray(state.last_observation)) - np.ravel(
            np.asarray(state.last_prediction))
        self._log(bo, f"{state.iteration} {_fmt(diff)}")
