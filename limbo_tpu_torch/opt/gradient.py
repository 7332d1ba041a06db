"""Gradient-based inner optimizers: Rprop, Adam, GradientAscent (port of
limbo_tpu/opt/gradient.py).

Each runs a fixed number of steps over a batch of starts at once (one
(R, d) tensor; a (d,) start is a batch of one) and tracks the best-seen
point per start, mirroring the reference update rules:

* Rprop      - src/limbo/opt/rprop.hpp:82   (delta0=0.1, dmin=1e-6, dmax=50,
               eta-=0.5, eta+=1.2, 300 iterations; sign-based)
* Adam       - src/limbo/opt/adam.hpp:94    (alpha=1e-3, b1=.9, b2=.999)
* GradAscent - src/limbo/opt/gradient_ascent.hpp:94 (plain/momentum/nesterov)

All maximize.  `bounded` projects iterates onto [0,1]^d each step.  The
gradient of the batch's summed value is each start's own gradient, since
the starts are independent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from limbo_tpu_torch.opt.base import OptResult, clip01


def _batch(init: torch.Tensor):
    """(d,) or (R, d) start -> ((R, d) batch, whether it was batched)."""
    return (init, True) if init.ndim == 2 else (init[None, :], False)


def _result(x, v, batched: bool) -> OptResult:
    return OptResult(x=x, value=v) if batched else OptResult(x=x[0],
                                                             value=v[0])


def _value_and_grad(fun: Callable, x: torch.Tensor):
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        v = fun(xg)
        (g,) = torch.autograd.grad(v.sum(), xg)
    return v.detach(), g


def _sanitize(v, g):
    """NaN/Inf guard per start: bad values lose and bad gradients become
    zero steps (limbo keeps the best-so-far, opt/nlopt_base.hpp:95-109)."""
    v = torch.where(torch.isfinite(v), v, torch.full_like(v, -torch.inf))
    g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    return v, g


def _final(fun: Callable, x, best_x, best_v):
    """The last iterate also competes (limbo returns best_params)."""
    with torch.no_grad():
        v = fun(x)
    v = torch.where(torch.isfinite(v), v, torch.full_like(v, -torch.inf))
    better = v > best_v
    return (torch.where(better[:, None], x, best_x),
            torch.where(better, v, best_v))


@dataclass
class Rprop:
    iterations: int = 300
    eps_stop: float = 0.0

    def __call__(self, fun: Callable, init: torch.Tensor, generator=None,
                 bounded: bool = False) -> OptResult:
        return self.run(fun, init, generator, bounded)[0]

    def run(self, fun: Callable, init, generator=None, bounded: bool = False,
            state=None, iterations: int | None = None):
        """Like __call__ but resumable: returns ``(OptResult, state)``.

        ``state`` is the full carry (iterate, per-dim deltas, previous
        gradient, best-seen, frozen flags), always batched (R, ...);
        passing a previous run's state continues the ascent where it
        stopped, with the adapted step sizes.
        """
        delta0, dmin, dmax = 0.1, 1e-6, 50.0
        etaminus, etaplus = 0.5, 1.2
        if state is None:
            x0, batched = _batch(clip01(init, bounded))
            R = x0.shape[0]
            state = (x0, torch.full_like(x0, delta0), torch.zeros_like(x0),
                     x0, torch.full((R,), -torch.inf, dtype=x0.dtype,
                                    device=x0.device),
                     torch.zeros((R,), dtype=torch.bool, device=x0.device))
        else:
            batched = True
        x, delta, grad_old, best_x, best_v, frozen = state
        n_steps = self.iterations if iterations is None else iterations
        for _ in range(n_steps):
            v, g = _sanitize(*_value_and_grad(fun, x))
            better = v > best_v
            best_x = torch.where(better[:, None], x, best_x)
            best_v = torch.where(better, v, best_v)
            # limbo works with grad of -f then flips; net effect: ascent on f
            prod = grad_old * g
            delta = torch.where(
                prod > 0, torch.clamp(delta * etaplus, max=dmax),
                torch.where(prod < 0, torch.clamp(delta * etaminus, min=dmin),
                            delta))
            g_eff = torch.where(prod < 0, torch.zeros_like(g), g)
            x_new = clip01(x + torch.sign(g_eff) * delta, bounded)
            grad_old = g_eff
            if self.eps_stop > 0:
                small = torch.linalg.norm(g_eff, dim=-1) < self.eps_stop
                frozen = frozen | small
            x = torch.where(frozen[:, None], x, x_new)
        best_x, best_v = _final(fun, x, best_x, best_v)
        state = (x, delta, grad_old, best_x, best_v, frozen)
        return _result(best_x, best_v, batched), state


@dataclass
class Adam:
    iterations: int = 300
    alpha: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __call__(self, fun: Callable, init: torch.Tensor, generator=None,
                 bounded: bool = False) -> OptResult:
        x, batched = _batch(clip01(init, bounded))
        m = torch.zeros_like(x)
        v_adam = torch.zeros_like(x)
        best_x = x
        best_v = torch.full((x.shape[0],), -torch.inf, dtype=x.dtype,
                            device=x.device)
        for t in range(self.iterations):
            v, g = _sanitize(*_value_and_grad(fun, x))
            better = v > best_v
            best_x = torch.where(better[:, None], x, best_x)
            best_v = torch.where(better, v, best_v)
            m = self.b1 * m + (1 - self.b1) * g
            v_adam = self.b2 * v_adam + (1 - self.b2) * g * g
            mhat = m / (1 - self.b1 ** (t + 1))
            vhat = v_adam / (1 - self.b2 ** (t + 1))
            x = clip01(x + self.alpha * mhat / (torch.sqrt(vhat) + self.eps),
                       bounded)
        return _result(*_final(fun, x, best_x, best_v), batched)


@dataclass
class GradientAscent:
    iterations: int = 300
    alpha: float = 1e-3
    gamma: float = 0.0
    nesterov: bool = False

    def __call__(self, fun: Callable, init: torch.Tensor, generator=None,
                 bounded: bool = False) -> OptResult:
        x, batched = _batch(clip01(init, bounded))
        vel = torch.zeros_like(x)
        best_x = x
        best_v = torch.full((x.shape[0],), -torch.inf, dtype=x.dtype,
                            device=x.device)
        for _ in range(self.iterations):
            v, g = _sanitize(*_value_and_grad(fun, x))
            better = v > best_v
            best_x = torch.where(better[:, None], x, best_x)
            best_v = torch.where(better, v, best_v)
            if self.nesterov:
                look = clip01(x + self.gamma * vel, bounded)
                vel = self.gamma * vel + self.alpha * _value_and_grad(
                    fun, look)[1]
            else:
                vel = self.gamma * vel + self.alpha * g
            x = clip01(x + vel, bounded)
        return _result(*_final(fun, x, best_x, best_v), batched)
