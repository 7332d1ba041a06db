"""IMGPO: Bayesian optimization with exponential convergence (NIPS 2015,
Kawaguchi, Kaelbling, Lozano-Perez; port of limbo_tpu/bo/imgpo.py).

Reference: src/limbo/experimental/bayes_opt/imgpo.hpp:86-417, a
hierarchical 3-way partition tree (SOO-style) whose candidate evaluations
are screened by GP-UCB bounds:

* **UCB_IMGPO screening with the M counter** (imgpo.hpp:274-300,
  experimental/acqui/ucb_imgpo.hpp:62): a new child is evaluated only when
  UCB(x; M) - LB >= 1e-6; otherwise it carries the optimistic GP estimate
  mu + (sqrt(2 log(pi^2 M^2 / (12 nu))) + 0.2) sigma, and M (the count of
  GP-screened points) increments.  The bound is the port's
  ``acqui.experimental.UCB_IMGPO``.
* **xi-lookahead** (step (iii), imgpo.hpp:169-249): before a selected cell
  at depth h is split, it is expanded virtually xi levels (xi = the
  distance to the next deeper selected cell, capped by ceil(XI) <= XI_max
  = 4) and its virtual descendants' UCBs screened against b_max[h + xi];
  if none can beat the deeper candidate, the cell is pruned this round.
* **XI adaptation** (imgpo.hpp:371-376): XI shrinks by 0.5 (floor 1) when
  the incumbent stalls and grows by 4 on improvement.

The partition tree (irregular, data-dependent) stays on the host in NumPy;
every GP fit and query runs on the optimizer's device, the GP refitted
from scratch each round in buffers of one capacity.  Nothing is drawn at
random (the optional final hp-opt aside), so a run is deterministic.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from limbo_tpu_torch.acqui.experimental import UCB_IMGPO
from limbo_tpu_torch.kernels import MaternFiveHalves
from limbo_tpu_torch.means import DataMean
from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.utils.device import resolve_device

_INF = math.inf


class _Cell:
    __slots__ = ("lo", "hi", "x", "f", "leaf", "sampled")

    def __init__(self, lo, hi, x, f, leaf=True, sampled=False):
        self.lo, self.hi, self.x, self.f = lo, hi, x, f
        self.leaf, self.sampled = leaf, sampled


def _split3(lo, hi, x):
    """3-way split along the widest dimension: (left, center, right) as
    (lo, hi, x) triples, the split points of imgpo.hpp:267-270 (the
    centers of the outer thirds)."""
    width = hi - lo
    d = int(np.argmax(width))
    third = width[d] / 3.0
    out = []
    for k in range(3):
        c_lo, c_hi = lo.copy(), hi.copy()
        c_lo[d] = lo[d] + k * third
        c_hi[d] = lo[d] + (k + 1) * third
        cx = x.copy()
        cx[d] = 0.5 * (c_lo[d] + c_hi[d])
        out.append((c_lo, c_hi, cx))
    return out[0], out[1], out[2]


class IMGPO:
    """GP-guided hierarchical partition search on [0,1]^dim
    (maximization)."""

    def __init__(self, kernel=None, mean=None, max_evals: int = 60,
                 nu: float = 0.05, xi_max: int = 4, max_depth: int = 20,
                 hp_opt=None, dtype=torch.float64, device="cuda"):
        self.device = resolve_device(device)
        self.kernel = kernel
        self.mean = mean
        self.max_evals = max_evals
        self.nu = nu                 # UCB_IMGPO confidence (ucb_imgpo.hpp)
        self.xi_max = xi_max         # XI_max (imgpo.hpp:118)
        self.max_depth = max_depth
        self.hp_opt = hp_opt         # optional final hp-opt (imgpo.hpp:379)
        self.dtype = dtype
        self.X: List[np.ndarray] = []
        self.Y: List[float] = []
        self.M = 1                   # GP-screened candidate counter
        self._ucb_acq = UCB_IMGPO(nu=nu)

    # -- GP helpers ----------------------------------------------------------

    def _fit_gp(self, capacity: int):
        kw = dict(device=self.device, dtype=self.dtype)
        kern = (self.kernel if self.kernel is not None
                else MaternFiveHalves.create(**kw))
        mean = (self.mean if self.mean is not None
                else DataMean.create(dim_out=1, **kw))
        X = torch.tensor(np.stack(self.X), **kw)
        Y = np.asarray(self.Y, dtype=np.float64)[:, None]
        return gp_mod.fit(kern, mean, X, Y, capacity=capacity, **kw)

    def _points(self, X: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(X), dtype=self.dtype,
                            device=self.device)

    def _moments(self, gp, X: np.ndarray):
        with torch.no_grad():
            mu, var = gp_mod.query(gp, self._points(X))
        return mu[:, 0].cpu().numpy(), var.cpu().numpy()

    def _varsigma(self, M: int) -> float:
        """UCB_IMGPO width (ucb_imgpo.hpp:62, imgpo.hpp:284)."""
        return math.sqrt(2.0 * math.log(
            math.pi ** 2 * max(M, 1) ** 2 / (12.0 * self.nu))) + 0.2

    def _ucb(self, gp, X: np.ndarray, M: int) -> np.ndarray:
        with torch.no_grad():
            return self._ucb_acq(gp, self._points(X), M=M).cpu().numpy()

    # -- the main loop -------------------------------------------------------

    def optimize(self, f: Callable, dim: int,
                 generator: Optional[torch.Generator] = None) -> "IMGPO":
        """Run until ``max_evals`` evaluations (or no cell splits).  f maps
        a (d,) numpy array to an observation whose first element is
        maximized.  generator: the final hp-opt's draws (default: seeded
        with 0), on this optimizer's device."""
        evals = 0

        def evaluate(x) -> float:
            nonlocal evals
            y = float(np.atleast_1d(np.asarray(f(x)))[0])
            self.X.append(np.asarray(x, dtype=np.float64))
            self.Y.append(y)
            evals += 1
            return y

        root_x = np.full(dim, 0.5)
        root = _Cell(np.zeros(dim), np.ones(dim), root_x, evaluate(root_x),
                     sampled=True)
        tree: List[List[_Cell]] = [[root]]
        capacity = max(64, -(-(self.max_evals * 2) // 64) * 64)
        LB = root.f
        LB_old = LB
        XI = 1.0

        while evals < self.max_evals:
            gp = self._fit_gp(capacity) if len(self.X) >= 2 else None
            depth_T = len(tree) - 1

            # ---- steps (i)-(ii): select best leaf per depth with the global
            # running max; realize GP-estimated selections (imgpo.hpp:134-167)
            i_max: List[int] = [-1] * (depth_T + 1)
            b_max: List[float] = [-_INF] * (depth_T + 1)
            b_hi_max = -_INF        # committed max over shallower selections
            for h in range(depth_T + 1):
                while True:
                    # fresh argmax at this depth vs the shallower-depth max:
                    # a realized GP estimate can DROP below a sibling, so the
                    # re-scan must not keep the stale optimistic value
                    best_i, best_f = -1, b_hi_max
                    for i, c in enumerate(tree[h]):
                        if c.leaf and c.f > best_f:
                            best_f = c.f
                            best_i = i
                    i_max[h] = best_i
                    if best_i == -1:
                        break
                    b_max[h] = best_f
                    cell = tree[h][best_i]
                    if cell.sampled or evals >= self.max_evals:
                        b_hi_max = best_f   # commit for deeper depths
                        break
                    cell.f = evaluate(cell.x)       # realize the GP estimate
                    cell.sampled = True
                    LB = max(LB, cell.f)

            # ---- step (iii): xi-lookahead pruning (imgpo.hpp:169-249) ----
            for h in range(depth_T + 1):
                if i_max[h] == -1 or gp is None:
                    continue
                xi = -1
                h2_cap = min(depth_T,
                             h + min(int(math.ceil(XI)), self.xi_max))
                for h2 in range(h + 1, h2_cap + 1):
                    if i_max[h2] != -1:
                        xi = h2 - h
                        break
                if xi == -1:
                    continue
                cell = tree[h][i_max[h]]
                z_max = -_INF
                M2 = self.M
                level = [(cell.lo, cell.hi, cell.x)]
                beaten = False
                for _ in range(xi):
                    nxt = []
                    for (lo, hi, x) in level:
                        left, center, right = _split3(lo, hi, x)
                        cand = np.stack([left[2], right[2]])
                        ucb = self._ucb(gp, cand, M2)
                        z_max = max(z_max, float(np.max(ucb)))
                        M2 += 2
                        if z_max >= b_max[h + xi]:
                            beaten = True
                            break
                        nxt.extend([left, center, right])
                    if beaten:
                        break
                    level = nxt
                if not beaten and z_max < b_max[h + xi]:
                    self.M = M2
                    i_max[h] = -1          # pruned this round

            # ---- steps (iv)-(v): split survivors, shallow to deep, with
            # UCB_IMGPO screening of the new children (imgpo.hpp:252-366)
            b_hi_max_2 = -_INF
            split_any = False
            for h in range(min(depth_T + 1, self.max_depth)):
                i = i_max[h]
                if i == -1 or not (b_max[h] > b_hi_max_2):
                    continue
                cell = tree[h][i]
                if evals >= self.max_evals:
                    break
                cell.leaf = False
                if h + 1 >= len(tree):
                    tree.append([])
                left, center, right = _split3(cell.lo, cell.hi, cell.x)
                for (c_lo, c_hi, x) in (left, right):
                    if gp is not None:
                        ucb = float(self._ucb(gp, x[None], self.M)[0])
                    else:
                        ucb = _INF
                    if gp is not None and (ucb - LB) < 1e-6:
                        # GP screen: optimistic estimate stands in
                        mu, var = self._moments(gp, x[None])
                        est = float(mu[0]
                                    + self._varsigma(self.M)
                                    * math.sqrt(max(float(var[0]), 0.0)))
                        self.M += 1
                        tree[h + 1].append(_Cell(c_lo, c_hi, x, est,
                                                 sampled=False))
                    elif evals < self.max_evals:
                        y = evaluate(x)
                        LB = max(LB, y)
                        b_hi_max_2 = max(b_hi_max_2, y)
                        tree[h + 1].append(_Cell(c_lo, c_hi, x, y,
                                                 sampled=True))
                    else:
                        tree[h + 1].append(_Cell(c_lo, c_hi, x, -_INF,
                                                 sampled=False))
                # center child inherits the parent's evaluation
                c_lo, c_hi, x = center
                tree[h + 1].append(_Cell(c_lo, c_hi, x, cell.f,
                                         sampled=cell.sampled))
                split_any = True

            # ---- XI adaptation (imgpo.hpp:371-376) ----
            if abs(LB_old - LB) < 1e-6:
                XI = max(XI - 0.5, 1.0)
            else:
                XI = XI + 4.0
            LB_old = LB

            if not split_any:
                break

        if self.hp_opt is not None and len(self.X) >= 2:
            gp = self._fit_gp(capacity)
            gen = (generator if generator is not None else
                   torch.Generator(device=self.device).manual_seed(0))
            self._final_gp = self.hp_opt(gp, gen)   # imgpo.hpp:379-380
        return self

    @property
    def best_value(self) -> float:
        return float(np.max(self.Y))

    @property
    def best_sample(self) -> np.ndarray:
        return self.X[int(np.argmax(self.Y))]
