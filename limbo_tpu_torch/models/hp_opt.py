"""Hyperparameter-learning strategies for the GP (port of
limbo_tpu/models/hp_opt.py).

Reference: src/limbo/model/gp/{hp_opt,kernel_lf_opt,kernel_loo_opt,
kernel_mean_lf_opt,mean_lf_opt,no_lf_opt}.hpp.  Each strategy is a callable
``(gp, generator) -> gp`` that maximizes a differentiable objective of the
flat log-parameter vector with its optimizer (autograd replaces limbo's
hand-derived gradients) and ends in ``recompute``.  At large n on the card
every objective evaluation is the fused training covariance, the blocked
Cholesky with the panel-factor kernel and, on the backward, the Cholesky
pullback through the tri-inv panel kernel (ops/chol.py).

The reference's robustness controls carry over:

* ``restarts`` / ``epsilon``: perturbed multi-start from the warm start
  (restart 0 keeps it exactly; ``_multi_start``).  The restarts run one
  after another, since each holds O(N^2) buffers at large n.
* ``objective_dtype="float64"`` evaluates the objective (and its gradient)
  in f64 while the optimizer iterates in the GP's dtype; ``rank_dtype``
  picks the multi-start winner by the objective in that dtype without the
  ridge.  On the card, f64 factors with ``cholesky_ex`` and inverts with the
  library triangular solve: no kernel of the port runs in f64.
* ``objective_jitter="auto"``: a parameter-independent ridge
  32 eps(dtype) N max(1, var y) on the objective's kernel diagonal only.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.opt.base import OptResult
from limbo_tpu_torch.opt.gradient import Rprop


def _default_opt():
    return Rprop(iterations=300)


def _cast_floats(module, dtype):
    """A copy of a kernel or mean module with its floating tensors cast."""
    return copy.deepcopy(module).to(dtype)


def _rowwise(objective: Callable) -> Callable:
    """The optimizers' batched protocol, (R, P) -> (R,), over an objective
    of one parameter vector (P,) -> scalar."""
    return lambda X: torch.stack([objective(x) for x in X])


def _multi_start(objective: Callable, init: torch.Tensor, optimizer,
                 generator, restarts: int, epsilon: float,
                 rank_objective: Optional[Callable] = None,
                 extra_inits=(), pert=None) -> OptResult:
    """Perturbed-restart wrapper (limbo_tpu/models/hp_opt.py:66-98;
    opt/parallel_repeater.hpp:77): restart r starts from init + pert[r],
    pert uniform in (-epsilon, epsilon) and drawn from ``generator`` unless
    given, with restart 0 the exact warm start and ``extra_inits`` in the
    next rows.  rank_objective, when given, picks the winner by its value at
    each restart's result instead of the ascent objective's."""
    fun = _rowwise(objective)
    if restarts <= 1:
        return optimizer(fun, init, generator, bounded=False)
    if pert is None:
        u = torch.rand((restarts, init.shape[0]), generator=generator,
                       dtype=init.dtype, device=init.device)
        pert = (2.0 * u - 1.0) * epsilon
    inits = init[None, :] + torch.as_tensor(pert, dtype=init.dtype,
                                            device=init.device)
    inits[0] = init
    for i, e in enumerate(extra_inits[:max(restarts - 1, 0)]):
        inits[1 + i] = e
    res = [optimizer(fun, x0, generator, bounded=False) for x0 in inits]
    xs = torch.stack([r.x for r in res])
    if rank_objective is not None:
        with torch.no_grad():
            value = torch.stack([rank_objective(x) for x in xs])
    else:
        value = torch.stack([r.value for r in res])
    value = torch.where(torch.isfinite(value), value,
                        torch.full_like(value, -torch.inf))
    best = torch.argmax(value)
    return OptResult(x=xs[best], value=value[best])


class _HPOptMixin:
    """Shared machinery: the dtype-lifted objective and the multi-start
    loop (limbo_tpu/models/hp_opt.py:101-164)."""

    def _run(self, gp: gp_mod.GP, generator, make_objective,
             init: torch.Tensor, pert=None) -> OptResult:
        dtype = init.dtype
        od = _dtype(self.objective_dtype)
        if od is not None:
            inner = make_objective(od)

            def objective(p):
                return inner(p.to(od)).to(dtype)
        else:
            objective = make_objective(None)
        rank_objective = None
        rd = _dtype(getattr(self, "rank_dtype", None))
        if rd is not None and self.restarts > 1:
            rank_inner = make_objective(rd, ridge=False)

            def rank_objective(p):
                return rank_inner(p.to(rd)).to(dtype)
        return _multi_start(objective, init, self.optimizer, generator,
                            self.restarts, self.epsilon,
                            rank_objective=rank_objective,
                            extra_inits=self._structured_inits(gp, init),
                            pert=pert)

    def _structured_inits(self, gp: gp_mod.GP, init: torch.Tensor):
        """Deterministic extra restart inits (strategy-specific)."""
        return ()

    def _lifted(self, gp: gp_mod.GP, od):
        """(kernel, mean, x, y), cast to the objective dtype if given."""
        if od is None:
            return gp.kernel, gp.mean, gp.x, gp.y
        return (_cast_floats(gp.kernel, od), _cast_floats(gp.mean, od),
                gp.x.to(od), gp.y.to(od))

    def _obj_jitter(self, gp: gp_mod.GP, od):
        """The objective-only diagonal ridge (None = off).  "auto" is
        32 eps(dtype) N max(1, var y): the f32 Cholesky's accumulation
        error for a spectrum bounded by N k_diag, with k_diag tracking the
        data variance (limbo_tpu/models/hp_opt.py:144-164).  A tensor, so
        no host sync."""
        oj = getattr(self, "objective_jitter", None)
        if oj is None:
            return None
        if oj == "auto":
            dt = od if od is not None else gp.x.dtype
            N = gp.x.shape[0]
            mask = gp.mask.to(gp.y.dtype)
            n = torch.clamp(torch.sum(mask), min=1.0)
            ym = torch.sum(gp.y * mask[:, None], dim=0) / n
            var = torch.sum(((gp.y - ym) ** 2) * mask[:, None]) / (
                n * gp.y.shape[1])
            scale = torch.clamp(var, min=1.0).to(dt)
            return 32.0 * float(torch.finfo(dt).eps) * N * scale
        return float(oj)


def _dtype(name) -> Optional[torch.dtype]:
    """"float64" / torch.float64 / None -> torch dtype or None."""
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def _tiny_noise_init(gp: gp_mod.GP, init: torch.Tensor):
    """When the kernel optimizes its noise (its last parameter), one restart
    starts from log_noise = log(0.01) (limbo_tpu/models/hp_opt.py:167-179):
    the large-noise warm start can absorb fine structure as noise."""
    if getattr(gp.kernel, "optimize_noise", False):
        e = init.clone()
        e[-1] = math.log(0.01)
        return (e,)
    return ()


@dataclass
class NoLFOpt:
    """Do-nothing strategy (limbo gp::NoLFOpt, no_lf_opt.hpp:57)."""

    def __call__(self, gp: gp_mod.GP, generator=None) -> gp_mod.GP:
        return gp


@dataclass
class _Strategy(_HPOptMixin):
    """The fields every learning strategy shares (the reference repeats
    them on each class)."""

    optimizer: object = field(default_factory=_default_opt)
    restarts: int = 1
    epsilon: float = 0.5
    objective_dtype: Optional[str] = None
    objective_jitter: Optional[object] = None
    # rank multi-start winners by the objective in THIS dtype without the
    # ridge (None = rank by the ascent objective's own values)
    rank_dtype: Optional[str] = None


@dataclass
class KernelLFOpt(_Strategy):
    """Max log-marginal-likelihood over the kernel parameters
    (kernel_lf_opt.hpp:57)."""

    def _structured_inits(self, gp, init):
        return _tiny_noise_init(gp, init)

    def __call__(self, gp: gp_mod.GP, generator=None,
                 pert=None) -> gp_mod.GP:
        """pert: the (restarts, P) restart perturbations, drawn from
        ``generator`` when None (a test hands in the reference's)."""
        def make_objective(od, ridge=True):
            kernel, mean, x, y = self._lifted(gp, od)
            ridge = self._obj_jitter(gp, od) if ridge else None

            def objective(p):
                return gp_mod.log_marginal_likelihood(
                    kernel.with_params(p), mean, x, y, gp.n,
                    extra_jitter=ridge)

            return objective

        res = self._run(gp, generator, make_objective, gp.kernel.params,
                        pert=pert)
        return gp_mod.recompute(
            gp.replace(kernel=gp.kernel.with_params(res.x)))


@dataclass
class KernelLooOpt(_Strategy):
    """Max LOO-CV log probability over the kernel parameters
    (kernel_loo_opt.hpp:57)."""

    def _structured_inits(self, gp, init):
        return _tiny_noise_init(gp, init)

    def __call__(self, gp: gp_mod.GP, generator=None) -> gp_mod.GP:
        def make_objective(od, ridge=True):
            kernel, mean, x, y = self._lifted(gp, od)
            ridge = self._obj_jitter(gp, od) if ridge else None

            def objective(p):
                return gp_mod.log_loo_cv_fn(
                    kernel.with_params(p), mean, x, y, gp.n,
                    extra_jitter=ridge)

            return objective

        res = self._run(gp, generator, make_objective, gp.kernel.params)
        return gp_mod.recompute(
            gp.replace(kernel=gp.kernel.with_params(res.x)))


@dataclass
class KernelMeanLFOpt(_Strategy):
    """Joint kernel + mean LML optimization (kernel_mean_lf_opt.hpp:57);
    the parameter vector is [kernel params, mean params] (limbo order)."""

    def __call__(self, gp: gp_mod.GP, generator=None) -> gp_mod.GP:
        nk = gp.kernel.params_size

        def make_objective(od, ridge=True):
            kernel, mean, x, y = self._lifted(gp, od)
            ridge = self._obj_jitter(gp, od) if ridge else None

            def objective(p):
                return gp_mod.log_marginal_likelihood(
                    kernel.with_params(p[:nk]), mean.with_params(p[nk:]),
                    x, y, gp.n, extra_jitter=ridge)

            return objective

        kp = gp.kernel.params
        init = torch.cat([kp, gp.mean.params.to(kp)])
        res = self._run(gp, generator, make_objective, init)
        return gp_mod.recompute(gp.replace(
            kernel=gp.kernel.with_params(res.x[:nk]),
            mean=gp.mean.with_params(res.x[nk:])))


@dataclass
class MeanLFOpt(_Strategy):
    """LML optimization over the mean parameters only
    (mean_lf_opt.hpp:57)."""

    def __call__(self, gp: gp_mod.GP, generator=None) -> gp_mod.GP:
        def make_objective(od, ridge=True):
            kernel, mean, x, y = self._lifted(gp, od)
            ridge = self._obj_jitter(gp, od) if ridge else None

            def objective(p):
                return gp_mod.log_marginal_likelihood(
                    kernel, mean.with_params(p), x, y, gp.n,
                    extra_jitter=ridge)

            return objective

        res = self._run(gp, generator, make_objective, gp.mean.params)
        return gp_mod.recompute(gp.replace(mean=gp.mean.with_params(res.x)))
