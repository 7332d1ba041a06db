"""Whole runs on the CPU at a small size (the look for a card skipped):
a sound run comes out correct, and a run whose timed path is broken
underneath comes out not correct, for each fault a cell can have: a step
that leaves its state unchanged (a lite flush that skips its rebuild with
it, in a window that closes before the run's first flush), an answer
altered where it is produced, and an acquisition gradient of the wrong
sign.  Then the control (the reference one precision down) fails each
cell's limits while the program at the same size passes them."""

import copy

import pytest
import torch

from perfbench import calibrate, run
from perfbench.reference import control

SMALL = {"config": {"n": 160, "capacity": 192,
                    "acquisition": {"ucb_alpha": 0.5, "restarts": 8,
                                    "steps": 3, "sweep": 32},
                    "hp_opt": {"iterations": 2, "repeats": 2}},
         "traffic": {"trace_after": 1, "trace_units": 1}}
CACHE = {"bo_loop_n16k": {"lite": False, "mirror_dtype": "bfloat16",
                          "defer_m": 8},
         "bo_loop_lite_n32k": {"lite": True, "mirror_dtype": "bfloat16",
                               "defer_m": 16},
         "hp_learn_n16k": {"lite": False, "mirror_dtype": "bfloat16",
                           "defer_m": 8},
         "refit_lite_n32k": {"lite": True, "mirror_dtype": "bfloat16",
                             "defer_m": 16}}
CELLS = list(CACHE)


def small(cell):
    ov = copy.deepcopy(SMALL)
    ov["config"]["cache"] = CACHE[cell]
    return ov


def run_small(cell, seed=20261018, seconds=0.6):
    return run.run_cell(cell, seed, seconds, trace=False, device="cpu",
                        overrides=small(cell))


def unchanged_append(monkeypatch):
    """The deferred append counts the sample and writes nothing."""
    from limbo_tpu_torch.models import gp as gp_mod

    def append(gp, cache, x, y, fast_update=False, flush=None):
        return gp.replace(n=gp.n + 1, n_dev=gp.n_dev + 1), cache
    monkeypatch.setattr(gp_mod, "add_sample_cached", append)


def altered_proposal(monkeypatch):
    """The acquisition's maximizer moves its answer after scoring it."""
    from limbo_tpu_torch.opt import compose

    orig = compose.RandomRestarts.__call__

    def call(self, fun, init, generator, bounded=True):
        res = orig(self, fun, init, generator, bounded)
        return res.__class__(x=(res.x + 0.05).clamp(0, 1), value=res.value)
    monkeypatch.setattr(compose.RandomRestarts, "__call__", call)


def unchanged_refit(monkeypatch):
    """The learning's closing refit keeps the fitted GP's factor."""
    from limbo_tpu_torch.models import gp as gp_mod

    orig = gp_mod.recompute
    first = {}

    def recompute(gp, update_obs_mean=True):
        if "gp" not in first:
            first["gp"] = orig(gp, update_obs_mean)
        return gp.replace(L=first["gp"].L, alpha=first["gp"].alpha)
    monkeypatch.setattr(gp_mod, "recompute", recompute)


def altered_lml(monkeypatch):
    """The objective returns its value moved by a part in a thousand."""
    from limbo_tpu_torch.models import gp as gp_mod

    orig = gp_mod.log_marginal_likelihood

    def lml(*a, **k):
        v = orig(*a, **k)
        return v + 1e-3 * v.detach().abs()
    monkeypatch.setattr(gp_mod, "log_marginal_likelihood", lml)


def unchanged_build(monkeypatch):
    """The cache build hands back the first cache it built."""
    from limbo_tpu_torch.models import gp as gp_mod

    orig = gp_mod.QueryCache.build
    first = {}

    def build(gp, *a, **k):
        if "c" not in first:
            first["c"] = orig(gp, *a, **k)
        return first["c"]
    monkeypatch.setattr(gp_mod.QueryCache, "build", staticmethod(build))


def altered_inverse(monkeypatch):
    """The build's L^-1 comes back with one entry off."""
    from limbo_tpu_torch.models import gp as gp_mod

    orig = gp_mod.tri_inv

    def tri_inv(L, *a, **k):
        V = orig(L, *a, **k)
        V[5, 3] += 1e-2
        return V
    monkeypatch.setattr(gp_mod, "tri_inv", tri_inv)


def flipped_gradient(monkeypatch):
    """The acquisition's variance comes back with the sign of its gradient
    flipped (its value unchanged): the ascent's backward is wrong."""
    from limbo_tpu_torch.acqui import acqui

    orig = acqui.query_any

    def query_any(gp, X):
        mu, var = orig(gp, X)
        return mu, 2.0 * var.detach() - var
    monkeypatch.setattr(acqui, "query_any", query_any)


def unrebuilt_mirror(monkeypatch):
    """The lite flush leaves the mirror as it was (it skips the rebuild
    from Linv)."""
    from limbo_tpu_torch.models import gp as gp_mod

    orig = gp_mod._mirror_from_linv

    def mirror_from_linv(Linv, qdtype, out=None, **k):
        return out if out is not None else orig(Linv, qdtype, **k)
    monkeypatch.setattr(gp_mod, "_mirror_from_linv", mirror_from_linv)


FAULTS = {
    "bo_loop_n16k": [unchanged_append, altered_proposal, flipped_gradient],
    "bo_loop_lite_n32k": [unchanged_append, altered_proposal,
                          flipped_gradient, unrebuilt_mirror],
    "hp_learn_n16k": [unchanged_refit, altered_lml],
    "refit_lite_n32k": [unchanged_build, altered_inverse],
}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]],
                         ids=lambda v: getattr(v, "__name__", v))
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run_small(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [None, unrebuilt_mirror],
                         ids=["sound", "unrebuilt_mirror"])
def test_window_closed_before_a_flush(fault, monkeypatch):
    """A window that closes before its run's first flush: the run is
    carried on past one, so the check reads a state that a flush
    rebuilt."""
    if fault:
        fault(monkeypatch)
    res = run.run_cell("bo_loop_lite_n32k", 20261019, 1e-3, trace=False,
                       device="cpu", overrides=small("bo_loop_lite_n32k"))
    assert 1 <= res["attempted"] < CACHE["bo_loop_lite_n32k"]["defer_m"]
    assert res["correct"] == (fault is None), res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell, monkeypatch):
    monkeypatch.setattr(control, "BLOCK", 16)
    units = 24 if "bo_loop" in cell else 1
    (rec,) = calibrate.calibrate(cell, [7], 1, units=units, device="cpu",
                                 overrides=small(cell))
    limits = run.harness.workload(cell)["limits"]
    assert set(rec["control"]) == set(limits) == set(rec["program"])
    assert all(rec["program"][k] <= limits[k] for k in limits), rec
    assert any(rec["control"][k] > limits[k] for k in limits), rec
    assert torch.get_default_dtype() == torch.float32
