"""DIRECT-L(-RAND): deterministic Lipschitzian global optimization (port of
limbo_tpu/opt/direct.py).

The reference's default acquisition optimizer is NLOpt's DIRECT-L-RAND
(boptimizer.hpp:120-127), a DIviding-RECTangles search (Jones et al. 1993;
locally biased as Gablonsky & Kelley 2001).  As the reference, one round
selects up to ``splits_per_round`` potentially-optimal rectangles at once
(the Lipschitz-slope test runs on the per-diameter-level minima) and
trisects them along their longest side, evaluating all new centers as one
batch; buffers are sized for the last round, so every round has the same
shapes and the search runs inside a captured BO iteration:

* the rectangle count is a device tensor, never read by the host;
* dead picks write a trash row (the last), which stays invalid;
* selection is a stable descending sort, the lower index first among
  equal scores, as ``jax.lax.top_k`` (exact ties occur on symmetric
  objectives, where the two children of a split score the same);
* the -RAND tie-break between equal longest sides takes draws of shape
  (rounds, S, d), all from the generator up front (``__call__``);
  ``from_draws`` is the deterministic rest, so a test hands in the
  reference's.

Minimization internally; the optimizer protocol maximizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from limbo_tpu_torch.opt.base import OptResult, take

_BIG = 1e30


@dataclass
class DirectL:
    """Locally-biased DIRECT with batched rounds: at most 1 + 2 * rounds *
    splits_per_round center evaluations (2049 at the defaults); epsilon is
    the standard nontrivial-improvement parameter."""

    rounds: int = 64
    splits_per_round: int = 16
    epsilon: float = 1e-4

    def __call__(self, fun: Callable, init: torch.Tensor,
                 generator: torch.Generator, bounded: bool = True
                 ) -> OptResult:
        if not bounded:
            raise ValueError("DirectL needs a bounded [0,1]^d domain "
                             "(limbo's acquisition optimizers are bounded; "
                             "use an unbounded optimizer otherwise)")
        u = torch.rand((self.rounds, self.splits_per_round, init.shape[0]),
                       generator=generator, dtype=init.dtype,
                       device=init.device)
        return self.from_draws(fun, init, u)

    def from_draws(self, fun: Callable, init: torch.Tensor,
                   u: torch.Tensor) -> OptResult:
        """The deterministic rest of __call__, given the tie-break draws u
        (rounds, S, d), uniform in [0, 1): the best center found."""
        c, _, f, valid, _ = self.rectangles(fun, init, u)
        fv = torch.where(valid, f, _BIG)
        i = torch.argmin(fv)
        return OptResult(x=take(c, i), value=-take(fv, i))

    def rectangles(self, fun: Callable, init: torch.Tensor, u: torch.Tensor):
        """Every round of the search: the final (centers (R, d), sides
        (R, d), values of -fun (R,), valid (R,), count), the centers in
        the order they were evaluated."""
        d, dtype, dev = init.shape[0], init.dtype, init.device
        kw = dict(dtype=dtype, device=dev)
        S = self.splits_per_round
        # +1: the last row is a permanent trash slot for masked-out writes
        R = 2 + 2 * S * self.rounds
        eps = self.epsilon

        def fmin_neg(X):                          # minimization inside
            with torch.no_grad():
                return -fun(X)

        c = torch.zeros((R, d), **kw)
        c[0] = 0.5
        side = torch.zeros((R, d), **kw)
        side[0] = 1.0
        f = torch.full((R,), _BIG, **kw)
        f[:1] = fmin_neg(c[:1])
        # no host scalar: a copy from the host cannot be captured
        valid = torch.arange(R, device=dev) == 0
        count = torch.ones((), dtype=torch.int64, device=dev)
        trash = torch.full((), R - 1, dtype=torch.int64, device=dev)
        # every side length is 3^-k, so rectangles group into at most
        # rounds + 2 diameter levels: the potentially-optimal test runs on
        # the per-level minima (L x L)
        L = self.rounds + 2
        log3 = torch.full((), math.log(3.0), **kw)
        lev_diam = torch.exp(-torch.arange(L, **kw) * log3)
        for r in range(self.rounds):
            diam = torch.max(side, dim=1).values               # (R,)
            fv = torch.where(valid, f, _BIG)
            fmin = torch.min(fv)
            # ---- per-diameter-level minima ----
            level = torch.where(
                valid, torch.round(-torch.log(torch.clamp(diam, min=1e-30))
                                   / log3).to(torch.int64), L - 1)
            lev_min = torch.full((L,), _BIG, **kw).scatter_reduce(
                0, level, fv, "amin", include_self=False)
            lev_has = torch.zeros((L,), dtype=torch.int64,
                                  device=dev).scatter_reduce(
                0, level, valid.to(torch.int64), "amax") > 0
            lev_f = torch.where(lev_has, lev_min, _BIG)
            # ---- potentially-optimal levels (L x L Lipschitz slopes) ----
            dd = lev_diam[None, :] - lev_diam[:, None]         # d_j - d_i
            df = lev_f[None, :] - lev_f[:, None]               # f_j - f_i
            both = lev_has[:, None] & lev_has[None, :]
            smaller = both & (dd < 0)
            k_lo = torch.max(torch.where(smaller, df / dd, 0.0), dim=1).values
            larger = both & (dd > 0)
            k_hi = torch.min(torch.where(larger, df / dd, _BIG), dim=1).values
            po_lev = (lev_has & (k_lo <= k_hi)
                      & (lev_f - k_hi * lev_diam
                         <= fmin - eps * torch.abs(fmin)))
            po = valid & po_lev[level] & (fv <= lev_f[level])
            # ---- up to S potentially-optimal rects, largest first ----
            score = torch.where(po, diam - 1e-9 * fv, -_BIG)
            sel_score, sel = torch.sort(score, descending=True, stable=True)
            sel_score, sel = sel_score[:S], sel[:S]
            live = sel_score > -_BIG
            sel = torch.where(live, sel, trash)   # dead picks -> trash row
            # ---- trisect each along its longest side (RAND tie-break) ----
            s_sel = side[sel]                                  # (S, d)
            tie = 1.0 + 1e-6 * u[r]
            jstar = torch.argmax(s_sel * tie, dim=1)           # (S,)
            delta = torch.gather(s_sel, 1, jstar[:, None])[:, 0] / 3.0
            e = (torch.arange(d, device=dev) == jstar[:, None]).to(dtype)
            c_sel = c[sel]
            kids = torch.cat([c_sel + delta[:, None] * e,
                              c_sel - delta[:, None] * e])     # (2S, d)
            fk = fmin_neg(kids)                                # (2S,)
            live2 = torch.cat([live, live])
            # the parent keeps its center; its split side shrinks to a
            # third, and the children inherit the shrunken sides
            s_new = s_sel * (1.0 - (2.0 / 3.0) * e)
            side[sel] = s_new                     # dead rows hit the trash
            # compacted slots: no gaps, so rounds never collide; dead
            # entries write the trash row (it stays invalid)
            pos = torch.cumsum(live2.to(torch.int64), 0) - 1
            slot = torch.where(live2, count + pos, trash)
            c[slot] = kids
            side[slot] = torch.cat([s_new, s_new])
            f[slot] = fk
            valid[slot] = live2
            count = count + torch.sum(live2)
        return c, side, f, valid, count
