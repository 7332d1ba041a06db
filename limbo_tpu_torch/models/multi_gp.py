"""MultiGP: one independent GP per output dimension (port of
limbo_tpu/models/multi_gp.py).

Reference: src/limbo/model/multi_gp.hpp:61, a wrapper holding one GP per
output (each may learn its own kernel hyperparameters), with the mean
function applied at the wrapper level.  Where the reference ``vmap``s the
single-GP functions over a stacked pytree, the port keeps a list of GPs
and loops over the outputs, as limbo's own TBB loop does
(multi_gp.hpp:124, multi_gp/parallel_lf_opt.hpp:57).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import torch

from limbo_tpu_torch.means.means import NullMean, prepare_mean
from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.utils.device import resolve_device


@dataclass
class MultiGP:
    """Per-output GPs and a wrapper-level mean function.

    gps: one single-output GP per output, each with a NullMean (the wrapper
    subtracts its own mean, as limbo does).  mean: (q, d) -> (q, p).
    """

    gps: List[gp_mod.GP]
    mean: object

    replace = replace

    @property
    def dim_in(self) -> int:
        return self.gps[0].dim_in

    @property
    def dim_out(self) -> int:
        return len(self.gps)

    @property
    def capacity(self) -> int:
        return self.gps[0].capacity

    @property
    def n(self) -> int:
        return self.gps[0].n

    @property
    def n_dev(self) -> torch.Tensor:
        return self.gps[0].n_dev

    @property
    def nb_samples(self) -> int:
        return self.gps[0].n


def empty(kernel, mean, dim_in: int, dim_out: int,
          capacity: int = gp_mod.DEFAULT_CAPACITY, device="cuda",
          dtype=torch.float32) -> MultiGP:
    """dim_out empty sub-GPs, each with its own copy of the kernel (their
    parameters may then diverge under per-output hp-opt)."""
    return MultiGP(gps=[gp_mod.empty(copy.deepcopy(kernel),
                                     NullMean(dim_out=1), dim_in, 1,
                                     capacity, device=device, dtype=dtype)
                        for _ in range(dim_out)], mean=mean)


def fit(kernel, mean, X, Y, capacity: Optional[int] = None, device="cuda",
        dtype=None) -> MultiGP:
    """Fit every output (limbo multi_gp.hpp:124 compute).  X: (n, d),
    Y: (n, p).  Each sub-GP is the fit of its centered output column."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    dtype = dtype if dtype is not None else (
        X.dtype if X.is_floating_point() else torch.float32)
    X = torch.atleast_2d(X.to(dtype))
    Y = torch.atleast_2d(torch.as_tensor(Y, device=dev).to(dtype))
    n, d = X.shape
    p = Y.shape[1]
    N = capacity if capacity is not None else gp_mod._round_capacity(n)
    mask = (torch.arange(N, device=dev) < n).to(dtype)
    ypad = torch.zeros((N, p), dtype=dtype, device=dev)
    ypad[:n] = Y
    mean = prepare_mean(mean, ypad, mask)
    xpad = torch.zeros((N, d), dtype=dtype, device=dev)
    xpad[:n] = X
    centered = (ypad - mean(xpad)) * mask[:, None]                # (N, p)
    gps = []
    for j in range(p):
        g = gp_mod.GP(kernel=copy.deepcopy(kernel), mean=NullMean(dim_out=1),
                      x=xpad.clone(), y=centered[:, j:j + 1].clone(), n=n,
                      L=torch.eye(N, dtype=dtype, device=dev),
                      alpha=torch.zeros((N, 1), dtype=dtype, device=dev))
        gps.append(gp_mod.recompute(g, update_obs_mean=False))
    return MultiGP(gps=gps, mean=mean)


def observations_padded(m: MultiGP) -> torch.Tensor:
    """The raw (N, p) observations from the centered sub-ys and the mean."""
    mask = m.gps[0].mask
    centered = torch.cat([g.y for g in m.gps], dim=1)             # (N, p)
    return (centered + m.mean(m.gps[0].x) * mask[:, None]) * mask[:, None]


def recompute(m: MultiGP, update_obs_mean: bool = True) -> MultiGP:
    """Refit every sub-GP after a change of hyperparameters or mean (limbo
    multi_gp.hpp recompute:254); with update_obs_mean the wrapper mean is
    rebuilt from the raw observations and the sub-ys re-centered."""
    if not update_obs_mean:
        return m.replace(gps=[gp_mod.recompute(g, update_obs_mean=False)
                              for g in m.gps])
    Y = observations_padded(m)
    g0 = m.gps[0]
    mask = g0.mask
    mean = prepare_mean(m.mean, Y, mask)
    centered = (Y - mean(g0.x)) * mask[:, None]
    gps = [gp_mod.recompute(g.replace(y=centered[:, j:j + 1].clone()),
                            update_obs_mean=False)
           for j, g in enumerate(m.gps)]
    return MultiGP(gps=gps, mean=mean)


def add_sample(m: MultiGP, x_new, y_new) -> MultiGP:
    """Rank-1 append to every sub-GP of y_new minus the wrapper mean at
    x_new.  For a DataMean wrapper, exact parity with ``fit`` needs a
    ``recompute`` after the appends (the reference's note, :131-138)."""
    g0 = m.gps[0]
    x_new = torch.as_tensor(x_new, dtype=g0.x.dtype, device=g0.x.device)
    y_new = torch.atleast_1d(torch.as_tensor(y_new, dtype=g0.x.dtype,
                                             device=g0.x.device))
    centered = y_new - m.mean(x_new[None, :])[0]                  # (p,)
    return m.replace(gps=[gp_mod.add_sample(g, x_new, centered[j:j + 1])
                          for j, g in enumerate(m.gps)])


def query(m: MultiGP, Xq) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu (q, p), sigma_sq (q, p)): one variance per output, as limbo's
    MultiGP::sigma (multi_gp.hpp:222)."""
    Xq = torch.atleast_2d(torch.as_tensor(Xq, device=m.gps[0].x.device))
    out = [gp_mod.query(g, Xq) for g in m.gps]
    mu = torch.cat([o[0] for o in out], dim=1) + m.mean(Xq.to(
        m.gps[0].x.dtype))
    return mu, torch.stack([o[1] for o in out], dim=1)


@dataclass
class ParallelLFOpt:
    """Per-output hyperparameter optimization (limbo
    multi_gp/parallel_lf_opt.hpp:57): ``hp_opt``, a single-GP strategy such
    as KernelLFOpt, runs on each sub-GP in turn."""

    hp_opt: object

    def __call__(self, m: MultiGP, generator=None,
                 perts: Optional[Sequence] = None) -> MultiGP:
        """generator: one torch.Generator per output (a sequence), or one
        shared by all.  perts: per output, the restart perturbations handed
        to the strategy (a test hands in the reference's)."""
        p = m.dim_out
        gens = (list(generator) if isinstance(generator, (list, tuple))
                else [generator] * p)
        gps = []
        for j, g in enumerate(m.gps):
            if perts is not None:
                gps.append(self.hp_opt(g, gens[j], pert=perts[j]))
            else:
                gps.append(self.hp_opt(g, gens[j]))
        return m.replace(gps=gps)
