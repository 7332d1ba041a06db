"""A closed multi-objective BO loop with one caller: limbo's Ehvi (one GP
per objective, the exact EHVI climbed from every Pareto point) over DTLZ2
evaluated on the host.

A unit is one ``Ehvi.iterate``: the refit of every objective's GP, the
observed front, the batched Rprop ascent of the EHVI from every front
point, DTLZ2 at the proposal and its append.  Then the unit reads to the
host, in one copy, the EHVI value the ascent returned, the ascent's
starts (the seeds: the observed front as the program held it), each
objective's posterior at the proposal and at PROBES of the ascent's last
iterates (``multi_gp.query`` on the model the ascent climbed, the graphs'
copy ``Ehvi.ascent_model``, before the next refit overwrites it), and the
kernel parameters that model holds.  The program's counters (``bo.multi.COUNTERS``:
the front's size and rows, the boxes a candidate, the seeds, the steps,
whether the ascent captured a CUDA graph) go into the unit's record.  The
set-up runs units until the front fits the smallest bucket, so every
bucket a run passes through is captured before the window.  When the loop holds ``capacity`` points its
data is cut back to the init design, a new BO run from the same data; the
restore is inside the window's time.

The check rebuilds, in float64 (reference/mo64.py), from the seed's init
design and the last run's proposals, for a sample of that run's
iterations, each over the data its iteration saw, with the kernel
parameters the configuration states: the non-dominated set against the
seeds the ascent started from (``front``: the points in one and not the
other, summed); the kernel parameters the climbed model held against the
configuration's (``kernel``: max relative difference); each objective's
posterior at the probed points (``post_mean``, ``post_var``: max
|program - reference| / max |reference|); and the EHVI at the proposal
over the whole front, against the value the ascent returned (``ehvi``,
the same measure over the sampled iterations).
"""

from __future__ import annotations

import math
import random
import sys
import time

import numpy as np
import torch

from perfbench.reference import control, mo64

SAMPLE = 8       # iterations of the last run compared, besides its first
#                  and its last
PROBES = 15      # last iterates whose posterior is read, besides the proposal


def dtlz2(x) -> np.ndarray:
    """DTLZ2 with 3 objectives at one point, maximized (as -f)."""
    x = np.asarray(x, dtype=np.float64)
    g = np.sum((x[2:] - 0.5) ** 2)
    a, b = 0.5 * np.pi * x[0], 0.5 * np.pi * x[1]
    return -(1.0 + g) * np.array([np.cos(a) * np.cos(b),
                                  np.cos(a) * np.sin(b), np.sin(a)])


class _Recorded:
    """The loop's Rprop as it runs, keeping the starts and the last
    iterates of its latest ascent at each number of starts.  On the card
    the ascent is a CUDA graph a front bucket, which calls this only at
    its warm-up and its capture: the tensors kept are then the graph's own
    input and output, which every replay of that bucket rewrites in
    place."""

    def __init__(self, opt):
        self.opt, self.iterations = opt, opt.iterations
        self.seen = {}          # starts -> (the starts, the last iterates)

    def __call__(self, fun, init, generator=None, bounded=False):
        res, state = self.opt.run(fun, init, generator, bounded)
        self.seen[init.shape[0]] = (init, state[0])
        return res


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from limbo_tpu_torch.bo import multi
        from limbo_tpu_torch.bo.init_designs import RandomSampling
        from limbo_tpu_torch.kernels import MaternFiveHalves
        from limbo_tpu_torch.means import NullMean
        from limbo_tpu_torch.opt import Rprop

        self.cfg = cfg
        self.dev = torch.device(device)
        self.d, self.p = cfg["dim"], cfg["n_objs"]
        self.n0, self.capacity = cfg["n"], cfg["capacity"]
        self.trace_after = traffic["trace_after"]
        self.trace_units = traffic["trace_units"]
        self.rng = random.Random(seed)
        self.gen = torch.Generator(device=self.dev).manual_seed(int(seed))
        k = cfg["kernel"]
        acq = cfg["acquisition"]
        self.opt = _Recorded(Rprop(iterations=acq["rprop_steps"]))
        self.counters, self.query = multi.COUNTERS, multi.multi_gp.query
        self.front_cap = multi.FRONT_CAP
        self.loop = multi.Ehvi(
            ref=tuple(cfg["ref"]), inner_opt=self.opt, q=acq["q"],
            kernel=MaternFiveHalves.create(
                sigma_sq=k["sigma_sq"], l=k["l"], noise=k["noise"],
                device=self.dev, dtype=torch.float32),
            mean=NullMean(dim_out=self.p), init=RandomSampling(self.n0),
            dtype=torch.float32, device=self.dev)
        self.loop._init_design(dtlz2, self.d, self.gen)
        self.X0, self.Y0 = list(self.loop.X), list(self.loop.Y)
        self.run = []            # records of the current BO run
        self.captures = 0        # ascents that captured a CUDA graph

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def restore(self) -> None:
        loop = self.loop
        loop.X, loop.Y, loop.iteration = list(self.X0), list(self.Y0), 0
        for r in self.run:          # only the last run's are compared
            for key in ("probe", "mu", "var", "seeds"):
                r.pop(key, None)
        self.run = []

    def warm(self) -> None:
        """Iterations until the front fits the smallest bucket (each larger
        bucket the run passes on its way is captured on the card, and the
        first iteration loads the libraries), at least two; a restore.
        Every run from the init design takes the same path, since nothing
        in an iteration draws at q = 1."""
        for i in range(self.capacity - self.n0):
            if self.unit()["front_cap"] == self.front_cap and i >= 1:
                break
        self.sync()
        self.restore()
        self.captures = 0

    def unit(self) -> dict:
        loop = self.loop
        restored = len(loop.X) >= self.capacity
        if restored:
            self.restore()
        n = len(loop.X)
        t0 = time.perf_counter()
        x, value = loop.iterate(dtlz2, self.d, self.gen, self.capacity)
        c = dict(self.counters)
        k = c["front"]
        starts, last = self.opt.seen[c["seeds"]]
        pick = sorted(self.rng.sample(range(k), min(PROBES, k)))
        P = torch.cat([torch.as_tensor(x, device=self.dev)[None],
                       last[pick]])
        model = loop.ascent_model
        with torch.no_grad():
            mu, var = self.query(model, P)
        hp = torch.stack([torch.exp(torch.stack([
            g.kernel.log_l, 2.0 * g.kernel.log_sigma,
            2.0 * g.kernel.log_noise])) for g in model.gps])
        out = torch.cat([value.reshape(1), P.reshape(-1), mu.reshape(-1),
                         var.reshape(-1), starts[:k].reshape(-1),
                         hp.reshape(-1)]).cpu()
        lat = time.perf_counter() - t0
        q, d, p = P.shape[0], self.d, self.p
        parts = torch.split(out, [1, q * d, q * p, q * p, k * d, 3 * p])
        rec = dict(c, latency=lat, n=n, restored=restored, x=x,
                   value=float(parts[0]), probe=parts[1].view(q, d),
                   mu=parts[2].view(q, p), var=parts[3].view(q, p),
                   seeds=parts[4].view(k, d), hp=parts[5].view(p, 3),
                   failed=not bool(torch.isfinite(out[:1 + q * (d + 2 * p)])
                                   .all()))
        self.run.append(rec)
        self.captures += c["captured"]
        return rec

    def settle(self) -> None:
        """Nothing to carry on: every iteration is whole."""

    # -- the check ---------------------------------------------------------

    def free(self) -> None:
        """Release the models (the check reads the records)."""
        self.loop.model = self.loop._captured = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def drop(self) -> None:
        """Release the program (after ``check``)."""
        self.loop = None

    def _sample(self, seed: int) -> list:
        """Indices into the last run: its first (the init design's front,
        the longest), SAMPLE drawn from the seed, and its last."""
        idx = list(range(len(self.run)))
        pick = random.Random(seed).sample(idx[1:-1],
                                          min(SAMPLE, max(0, len(idx) - 2)))
        return sorted(set(pick) | {0, idx[-1]})

    def _reference(self, seed: int) -> None:
        """The last run's data in f64, the sampled iterations, and the
        reference GP over the data at the configuration's kernel parameters
        (the diagonal's jitter is the f32 program's, 32 f32 epsilons)."""
        k = self.cfg["kernel"]
        self.X = torch.as_tensor(
            np.stack(self.X0 + [r["x"] for r in self.run]),
            dtype=torch.float64, device=self.dev)
        self.Y = mo64.dtlz2(self.X)
        self.kparams = (k["l"], k["sigma_sq"], k["noise"], 32.0 * 2.0 ** -23)
        self.idx = self._sample(seed)
        self.gp = mo64.GP(self.X, self.Y, *self.kparams)

    def _ehvi64(self, i: int, mu, var) -> float:
        """The reference EHVI at iteration i's proposal, from the posterior
        (mu, var) there ((1, p) each), over the whole front of the data it
        saw."""
        Y = self.Y[:self.run[i]["n"]]
        sigma = torch.sqrt(torch.clamp(var.to(self.dev), min=1e-20))
        return float(mo64.ehvi3(mu.to(self.dev), sigma, Y[
            mo64.non_dominated(Y)], self.cfg["ref"])[0])

    def _readings(self, post, values) -> dict:
        """The readings of the posteriors ``post`` ((mean, variance), (q, p)
        each, per sampled iteration, the proposal first) and of the EHVI
        values at the proposals, against the reference's."""
        dm = dv = tm = tv = 0.0
        gaps, refs = [], []
        for i, (mu, var), value in zip(self.idx, post, values):
            r = self.run[i]
            mu64, v64 = self.gp.posterior(r["probe"].to(self.dev), r["n"])
            v64 = v64.clamp(min=0.0)[:, None].expand_as(mu64)
            dm = max(dm, float((mu.to(self.dev) - mu64).abs().max()))
            dv = max(dv, float((var.to(self.dev) - v64).abs().max()))
            tm = max(tm, float(mu64.abs().max()))
            tv = max(tv, float(v64.max()))
            refs.append(self._ehvi64(i, mu64[:1], v64[:1]))
            gaps.append(abs(value - refs[-1]))
        top = max(abs(e) for e in refs)
        return {"post_mean": dm / tm, "post_var": dv / tv,
                "ehvi": max(gaps) / top if top > 0 else math.inf}

    def check(self, seed: int) -> dict:
        self._reference(seed)
        miss, fronts = 0, []
        for i in self.idx:
            r = self.run[i]
            Y = self.Y[:r["n"]]
            F = self.X[:r["n"]][mo64.non_dominated(Y)]
            S = r["seeds"].to(self.dev, torch.float64)
            eq = (S[:, None, :] == F[None, :, :]).all(-1)
            miss += int((~eq.any(1)).sum()) + int((~eq.any(0)).sum())
            fronts.append((F.shape[0], r["front"], r["front_cap"]))
        want = torch.tensor(self.kparams[:3], dtype=torch.float64)
        out = {"front": float(miss), "kernel": max(
            float(((self.run[i]["hp"].double() - want).abs() / want).max())
            for i in self.idx)}
        out.update(self._readings(
            [(self.run[i]["mu"], self.run[i]["var"]) for i in self.idx],
            [self.run[i]["value"] for i in self.idx]))
        self.diag = {"fronts": fronts, "iterations": self.idx,
                     "run": len(self.run)}
        print(f"[perfbench] mo fronts (brute force, program, rows) at "
              f"iterations {self.idx} of the last run: {fronts}; graphs "
              f"captured after the set-up: {self.captures}",
              file=sys.stderr, flush=True)
        return out

    def control(self, seed: int) -> dict:
        """The control's readings: the posterior at the program's probed
        points with every product in TF32 (reference/control.py: the
        blocked factor, L^-1, the solves' products, the means), and the
        EHVI at the proposal from it; the front and the kernel parameters
        are the reference's own."""
        X32 = self.X.to(torch.float32)
        ell, sf2, noise, jitter = self.kparams
        m_max = max(self.run[i]["n"] for i in self.idx)
        K = mo64.cov(X32[:m_max], X32[:m_max], ell, sf2)
        K.diagonal().add_(noise + jitter * max(sf2, 1.0))
        L = control.cholesky(K)
        del K
        Linv = control.tri_inv(L)
        Y32 = self.Y.to(torch.float32)
        post = []
        for i in self.idx:
            r = self.run[i]
            m = r["n"]
            k = mo64.cov(X32[:m], r["probe"].to(self.dev), ell, sf2)
            v = control.mm(Linv[:m, :m], k)
            z = control.mm(Linv[:m, :m], Y32[:m])
            mu = control.mm(v.T, z)
            var = (sf2 - v.square().sum(0))[:, None].expand_as(mu)
            post.append((mu.double(), var.clamp(min=0.0).double()))
        values = [self._ehvi64(i, mu[:1], var[:1])
                  for i, (mu, var) in zip(self.idx, post)]
        out = {"front": 0.0, "kernel": 0.0}
        out.update(self._readings(post, values))
        return out
