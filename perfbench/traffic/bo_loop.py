"""A closed BO loop with one caller: the captured iteration over a large
fitted GP and its query cache.

A unit is one iteration: ``BOStep.step()`` (the acquisition's maximizer of
UCB by RandomRestarts(Rprop(steps), restarts, a sweep), the objective
sin(3 sum x) on the device and the deferred append, which flushes every
``defer_m`` appends), then the proposal and its acquisition value read to
the host.  The latency of a unit runs from the call of ``step()`` to that
read.  When the next append would not fit the capacity, the state restored
from the set-up's snapshot (``BOStep.assign``) starts a new BO run from the
same data; the restore is inside the window's time, not in a latency.  The
same read brings back, from the acquisition's ascent, the iterates, the
UCB values and the gradients of the first and the last Rprop step (a hook
on the iterate copies the gradient that Rprop takes into the read
buffer).

After the window the last run is carried on, on the same step, until it
has passed a flush (``settle``): a window may close before a run's first
flush, and the check has to read a state that a flush rebuilt.  The check
rebuilds, from the generated data and the proposals of the last run (the
iterations since the last restore), the state those appends left (L,
Linv, alpha, the f32 K^-1 master and the mirror, each with the pending
pivots); the UCB value at a sample of that run's proposals, each over the
data its iteration saw: the variance that value implies over the
reference's mean, against the reference's variance (the root mean square
of the gaps over the sample); and the ascent's gradients at a sample of
its iterations, as the variance gradient they imply against the
reference's.  The variance gradient a UCB gradient g implies is
2 s (g - dmean) / alpha, s = (ucb - mean) / alpha the standard deviation
the UCB value implies, over the reference's mean and its gradient: this
undoes UCB's square root, whose 1 / (2 s) would magnify a gap wherever the
variance is small.
"""

from __future__ import annotations

import copy
import math
import random
import time

import torch

from perfbench import gpdata
from perfbench.reference import control, gp64

SAMPLE = 48          # proposals of the last run compared, besides its last
GSAMPLE = 16         # iterations whose ascent gradients are compared, besides
#                      the last


def _clone(t):
    return None if t is None else t.clone()


def _keep(slot, g) -> None:
    """A gradient hook that copies the gradient and leaves it as it is."""
    slot.copy_(g)


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from limbo_tpu_torch.acqui import UCB
        from limbo_tpu_torch.bo.graph import BOStep
        from limbo_tpu_torch.opt import RandomRestarts, Rprop

        self.cfg = cfg
        self.dev = torch.device(device)
        self.d = d = cfg["dim"]
        acq = cfg["acquisition"]
        self.ucb_alpha = acq["ucb_alpha"]
        self.m = cfg["cache"]["defer_m"]
        self.lite = cfg["cache"]["lite"]
        self.trace_after = traffic["trace_after"]
        self.trace_units = traffic["trace_units"]
        self.gen, self.X, self.Y = gpdata.make_data(cfg, seed, self.dev)
        kernel, mean = gpdata.make_model(cfg, self.dev)
        gp = gpdata.fit(cfg, kernel, mean, self.X, self.Y, self.dev)
        cache = gpdata.build(cfg, gp)
        self.theta = gpdata.program_theta(gp.kernel)
        self.n0, self.capacity = gp.n, gp.capacity
        # the snapshot every BO run starts from (the step writes its GP and
        # cache in place)
        self.snap = (gp.replace(
            x=gp.x.clone(), y=gp.y.clone(), L=gp.L.clone(),
            alpha=gp.alpha.clone(), n_dev=gp.n_dev.clone(),
            mean=copy.deepcopy(gp.mean)),
            cache.replace(
                Kinv=_clone(cache.Kinv), Linv=_clone(cache.Linv),
                Kinv_q=_clone(cache.Kinv_q), P=_clone(cache.P),
                ay=_clone(cache.ay), u_ones=_clone(cache.u_ones),
                base_n_dev=_clone(cache.base_n_dev)))
        # the read buffer: the proposal, its value, and for each probed step
        # and restart the iterate, the gradient and the UCB value
        self.probe_at = probe_at = sorted({0, acq["steps"] - 1})
        self.probe_shape = (len(probe_at), acq["restarts"], 2 * d + 1)
        self.rec = torch.zeros(d + 1 + math.prod(self.probe_shape),
                               device=self.dev)
        probe = self.rec[d + 1:].view(self.probe_shape)
        opt = RandomRestarts(sub=Rprop(iterations=acq["steps"]),
                             repeats=acq["restarts"],
                             sweep_samples=acq["sweep"])
        ucb = UCB(alpha=self.ucb_alpha)
        start = torch.full((d,), 0.5, device=self.dev)
        rec = self.rec
        steps = [0]

        def acquisition(model):
            def fun(Z):
                v = ucb(model, Z)
                if Z.requires_grad:           # an Rprop step's iterate
                    if steps[0] in probe_at:
                        slot = probe[probe_at.index(steps[0])]
                        slot[:, :d].copy_(Z.detach())
                        slot[:, 2 * d].copy_(v.detach())
                        Z.register_hook(
                            lambda g, s=slot[:, d:2 * d]: _keep(s, g))
                    steps[0] += 1
                return v
            return fun

        def propose(model, it):
            steps[0] = 0
            res = opt(acquisition(model), start, self.gen, True)
            rec[:d].copy_(res.x)
            rec[d:d + 1].copy_(res.value.reshape(1))
            return res.x

        def objective(x):
            return torch.sin(3.0 * torch.sum(x))[None]

        self.step = BOStep(gp, cache, propose, objective, self.gen,
                           fast_update="deferred")
        self.run = []            # records of the current BO run
        # the device's span of a step, from before its launch to its end
        cuda = self.dev.type == "cuda"
        self.events = [torch.cuda.Event(enable_timing=True) if cuda else None
                       for _ in range(2)]

    def sync(self) -> None:
        gpdata.sync(self.dev)

    def restore(self) -> None:
        self.step.assign(*self.snap)
        for r in self.run:
            r.pop("probe", None)     # only the last run's are compared
        self.run = []

    def warm(self) -> None:
        """The first step (run eagerly, then both graphs captured), a
        replay of each graph, a restore."""
        self.step.step()
        self.step.step(flush=True)
        self.step.step(flush=False)
        self.sync()
        self.restore()
        self.sync()

    def unit(self) -> dict:
        step = self.step
        restored = step.gp.n >= self.capacity
        if restored:
            self.restore()
        n, base = step.gp.n, step.cache.base_n
        flush = n - base + 1 >= self.m
        e0, e1 = self.events
        t0 = time.perf_counter()
        if e0 is not None:
            e0.record()
        step.step()
        if e1 is not None:
            e1.record()
        out = self.rec.to("cpu", copy=True)
        lat = time.perf_counter() - t0
        d = self.d
        x, value = out[:d], float(out[d])
        rec = {"latency": lat, "n": n, "pending": n - base, "flush": flush,
               "device_s": None if e0 is None else e0.elapsed_time(e1) / 1e3,
               "restored": restored, "x": x, "value": value,
               "probe": out[d + 1:].view(self.probe_shape),
               "failed": not bool(torch.isfinite(out[:d + 1]).all())}
        self.run.append(rec)
        return rec

    def settle(self) -> None:
        """Carry the last BO run on, after the window and on the same step,
        until it has passed a flush or filled the capacity."""
        while (not any(r["flush"] for r in self.run)
               and self.step.gp.n < self.capacity):
            self.unit()

    # -- the check ---------------------------------------------------------

    def free(self) -> None:
        """Release what the check does not read: the graphs and the
        snapshot."""
        self.step.graphs.graphs = None
        self.step.graphs.draws = None
        self.snap = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def drop(self) -> None:
        """Release the program's state (after ``check``)."""
        self.step = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _data(self):
        run = self.run
        A = (torch.stack([r["x"] for r in run]).to(self.dev, torch.float64)
             if run else torch.zeros((0, self.d), dtype=torch.float64,
                                     device=self.dev))
        X = torch.cat([self.X.double(), A])
        Y = torch.cat([self.Y.double(), gpdata.objective_rows(A)])
        return X, Y

    def _sample(self, seed: int, last_bases=None, k: int = SAMPLE) -> list:
        """Indices into the last run: k drawn from the seed, and the last;
        with ``last_bases``, only iterations whose flush base is one of the
        run's last ones."""
        idx = list(range(len(self.run)))
        if last_bases is not None:
            bases = sorted({self._base(i) for i in idx})[-last_bases:]
            idx = [i for i in idx if self._base(i) in bases]
        if not idx:
            return []
        pick = random.Random(seed).sample(idx[:-1], min(k, len(idx) - 1))
        return sorted(set(pick) | {idx[-1]})

    def _base(self, i: int) -> int:
        """The flush base the run's iteration i queried: n at its last
        flush."""
        return self.n0 + self.m * (i // self.m)

    def _ucb64(self, ref, Y, idx):
        Q = torch.stack([self.run[i]["x"] for i in idx]).to(self.dev)
        Qs = gp64.scaled(Q, self.theta[:self.d])
        m = [self.n0 + i for i in idx]
        mean, var, _ = gp64.prefix_posterior(ref.L, ref.Xs, Y, Qs, m,
                                             ref.sf2)
        return Qs, mean, var

    def check(self, seed: int) -> dict:
        gp, cache = self.step.gp, self.step.cache
        n = gp.n
        if n != self.n0 + len(self.run):
            raise AssertionError(f"the GP holds {n} points, the last run "
                                 f"appended {len(self.run)} to {self.n0}")
        X, Y = self._data()
        ref = gp64.State(X, Y, self.theta, self.cfg["noise"])
        out = {"L": gp64.rel_max(gp.L[:n, :n], ref.L),
               "Linv": gp64.rel_max(cache.Linv[:n, :n], ref.Linv),
               "alpha": gp64.rel_max(gp.alpha[:n], ref.alpha)}
        if cache.Kinv is not None:
            out["kinv"] = self._query_matrix(cache.Kinv, ref.Kinv)
        out["mirror"] = self._query_matrix(cache.Kinv_q, ref.Kinv)
        idx = self._sample(seed)
        _, mean, var = self._ucb64(ref, Y, idx)
        got = torch.tensor([self.run[i]["value"] for i in idx],
                           dtype=torch.float64, device=self.dev)
        # the variance the UCB value implies over the reference's mean: the
        # square root would shrink a gap of the mirror's variance
        s = (got - mean) / self.ucb_alpha
        gap = s * s.abs() - var.clamp(min=0.0)
        out["ucb_var"] = float(gap.square().mean().sqrt())
        self.diag = {"ucb_var_max": float(gap.abs().max())}
        self.ref = ref
        g = self._grad_ref(ref, Y, self._sample(seed, 2, GSAMPLE))
        out["ucb_grad"] = self._grad_gap(g["implied"], g, "grad_rows")
        return out

    def _grad_ref(self, ref, Y, idx) -> dict:
        """The probed iterates of iterations idx, the variance gradient the
        program's UCB value and gradient imply there, and the reference's
        mean and variance gradients in the unscaled inputs, each over the
        data its iteration saw."""
        pr = torch.stack([self.run[i]["probe"] for i in idx]).to(self.dev)
        d = self.d
        pr = pr.double().reshape(-1, 2 * d + 1)
        its = [i for i in idx for _ in range(pr.shape[0] // len(idx))]
        Qs = gp64.scaled(pr[:, :d], self.theta[:d])
        ell = torch.exp(self.theta[:d]).to(self.dev)
        mean, var, dmean, dvar, k, _ = gp64.prefix_posterior_grad(
            ref.L, ref.Xs, Y, Qs, [self.n0 + i for i in its], ref.sf2)
        dmean, dvar = dmean / ell, dvar / ell
        a = self.ucb_alpha
        s = (pr[:, 2 * d] - mean) / a
        return {"implied": 2.0 * s[:, None] * (pr[:, d:2 * d] - dmean) / a,
                "its": its, "Qs": Qs, "ell": ell, "var": var,
                "dvar": dvar, "k": k}

    def _grad_gap(self, dv, g, key: str) -> float:
        """Variance gradients ``dv`` against the reference's: the root mean
        square of their gap over the reference's, on the rows where ``dv``
        is finite (a variance clamped at 0 has no gradient), and infinite
        when fewer than half are (their count goes to the diagnostics under
        ``key``)."""
        ok = torch.isfinite(dv).all(1)
        self.diag[key] = [int(ok.sum()), len(ok)]
        if 2 * int(ok.sum()) < len(ok):
            return math.inf
        gap = dv[ok] - g["dvar"][ok]
        return float(gap.square().mean().sqrt()
                     / g["dvar"][ok].square().mean().sqrt())

    def _query_matrix(self, M, Kinv64) -> float:
        """rel_max of the matrix the queries read, M + P P^T - diag(pend),
        against the exact K^-1, in row blocks."""
        cache, n = self.step.cache, self.step.gp.n
        P = cache.P[:n].double()
        lo = self._base(len(self.run))
        top = float(Kinv64.abs().max())
        worst = 0.0
        for r0 in range(0, n, 2048):
            r1 = min(n, r0 + 2048)
            blk = M[r0:r1, :n].double() + P[r0:r1] @ P.T
            i = torch.arange(r0, r1, device=blk.device)
            pend = (i >= lo).double()
            blk[torch.arange(r1 - r0, device=blk.device), i] -= pend
            worst = max(worst, float((blk - Kinv64[r0:r1]).abs().max()))
        return worst / top

    def control(self, seed: int) -> dict:
        """The readings of the control in the program's place: L, Linv,
        alpha and K^-1 in TF32; the mirror, and the variance and the UCB
        gradient through it, in float8 (the pending pivots exact, as the
        program keeps them in f32), at the program's probed iterates.  Run
        after ``check`` (it reuses the reference), with the program's
        state released."""
        ref = self.ref
        X, Y = self._data()
        cs = control.State(X, Y, self.theta, self.cfg["noise"])
        out = {"L": gp64.rel_max(cs.L, ref.L),
               "Linv": gp64.rel_max(cs.Linv, ref.Linv),
               "alpha": gp64.rel_max(cs.alpha, ref.alpha)}
        if not self.lite:
            out["kinv"] = gp64.rel_max(cs.Kinv, ref.Kinv)
        del cs
        top = float(ref.Kinv.abs().max())
        idx = self._sample(seed, last_bases=2)
        Qs, mean, var = self._ucb64(ref, Y, idx)
        k = gp64.cov(ref.Xs, Qs, ref.sf2)
        var_c = var.clone()
        g = self._grad_ref(ref, Y, self._sample(seed, 2, GSAMPLE))
        gbase = [self._base(i) for i in g["its"]]
        gvar, gdvar = g["var"].clone(), g["dvar"].clone()
        final = self._base(len(self.run))
        for b in sorted({self._base(i) for i in idx} | set(gbase) | {final}):
            E = ref.prefix_kinv(b)
            E.sub_(control.fp8(E)).neg_()          # fp8(K_b^-1) - K_b^-1
            if b == final:
                out["mirror"] = float(E.abs().max()) / top
            for j, i in enumerate(idx):
                if self._base(i) == b:
                    kb = k[:b, j]
                    var_c[j] -= kb @ (E @ kb)
            cols = [j for j, c in enumerate(gbase) if c == b]
            if cols:
                # var - k^T E k and its gradient, 2 sum_j (E k)_j k_j (q - x_j)
                kb = g["k"][:b, cols]
                w = (E @ kb).mul_(kb)
                gvar[cols] -= w.sum(0)
                gdvar[cols] += 2.0 * (g["Qs"][cols] * w.sum(0)[:, None]
                                      - w.T @ ref.Xs[:b]) / g["ell"]
                del kb, w
            del E
        gap = var_c.clamp(min=0.0) - var.clamp(min=0.0)
        out["ucb_var"] = float(gap.square().mean().sqrt())
        self.diag["control_ucb_var_max"] = float(gap.abs().max())
        gdvar[gvar <= 0] = math.nan
        out["ucb_grad"] = self._grad_gap(gdvar, g, "control_grad_rows")
        return out
