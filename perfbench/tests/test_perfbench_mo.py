"""The multi-objective cell on the CPU at a small size: the reference's exact
3-D EHVI against the port's native Hupkens EHVI and a Monte Carlo
estimate, its GP and front against the program's in float64, a sound run
correct, a run whose front is cut to the 64-point subsample that the loop
used to keep and one whose ascent climbs a model the refits never reach
not correct, the TF32 control failing the cell's limits while the program
passes them, and the flop count of a known iteration.

The small size keeps the configuration's width (d = 12) and its loop at
n = 768, where a random design's front has 65 to 97 points (more than
the old cap of 64), with 2 Rprop steps an ascent."""

import numpy as np
import pytest
import torch

from perfbench import calibrate, run
from perfbench.counts import flops, mo_flops
from perfbench.reference import control, mo64

CELL = "mo_ehvi3_dtlz2_n4096"
SMALL = {"config": {"n": 768, "capacity": 832,
                    "acquisition": {"q": 1, "rprop_steps": 2}},
         "traffic": {"trace_after": 1, "trace_units": 1}}
REF = np.array([-1.1, -1.1, -1.1])


def run_small(seed=20261020, seconds=1.0):
    return run.run_cell(CELL, seed, seconds, trace=False, device="cpu",
                        overrides=SMALL)


def subsampled_front(monkeypatch):
    """The observed front cut to 64 points evenly spread along objective 0
    (what the loop kept of a longer front before)."""
    from limbo_tpu_torch.bo import multi

    def padded_front(self, dim):
        Xp, Yp = self.pareto_data()
        if len(Xp) > 64:
            order = np.argsort(Yp[:, 0])
            pick = order[np.linspace(0, len(order) - 1, 64).round()
                         .astype(int)]
            Xp, Yp = Xp[pick], Yp[pick]
        k = len(Xp)
        fx, fy, fm = np.zeros((64, dim)), np.tile(self.ref, (64, 1)), \
            np.zeros(64)
        fx[:k], fy[:k], fm[:k] = Xp, Yp, 1.0
        multi.COUNTERS.update(front=k, front_cap=64)
        return self._tensor(fx), self._tensor(fy), self._tensor(fm)
    monkeypatch.setattr(multi.Ehvi, "padded_front", padded_front)


def test_ehvi3_equals_native_and_monte_carlo():
    from limbo_tpu_torch import native

    rng = np.random.default_rng(11)
    Y = mo64.dtlz2(torch.as_tensor(rng.uniform(size=(60, 3))))
    F = Y[mo64.non_dominated(Y)]
    F = torch.cat([F, F[:1], F[1:2] - 0.5])       # a tie, a clipped point
    F = F[mo64.non_dominated(F)]
    mu = torch.as_tensor(rng.uniform(-1.2, -0.3, size=(6, 3)))
    sigma = torch.as_tensor(rng.uniform(0.02, 0.4, size=(6, 3)))
    got = mo64.ehvi3(mu, sigma, F, REF)
    want = native.ehvi3d_host(mu.numpy(), sigma.numpy(), F.numpy(), REF)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    # Monte Carlo: the mean hypervolume gain of 20,000 draws of the first
    hv0 = native.hv_host(F.numpy(), REF)
    draws = (mu[0] + sigma[0] * torch.as_tensor(
        rng.standard_normal((20000, 3)))).numpy()
    gain = np.array([native.hv_host(np.vstack([F.numpy(), y]), REF) - hv0
                     for y in draws])
    se = gain.std() / np.sqrt(len(gain))
    assert abs(gain.mean() - float(got[0])) < 5 * se


def test_gp_and_front_equal_the_program_in_f64():
    from limbo_tpu_torch import native
    from limbo_tpu_torch.kernels import MaternFiveHalves
    from limbo_tpu_torch.means import NullMean
    from limbo_tpu_torch.models import multi_gp

    rng = np.random.default_rng(12)
    X = torch.as_tensor(rng.uniform(size=(200, 12)))
    Y = mo64.dtlz2(X)
    kw = dict(device="cpu", dtype=torch.float64)
    m = multi_gp.fit(MaternFiveHalves.create(**kw), NullMean(dim_out=3), X,
                     Y, capacity=256, **kw)
    Q = torch.as_tensor(rng.uniform(size=(7, 12)))
    mu, var = multi_gp.query(m, Q)
    mu64, var64 = mo64.GP(X, Y, 1.0, 1.0, 0.01, 1e-8).posterior(Q, 200)
    np.testing.assert_allclose(mu.numpy(), mu64.numpy(), rtol=1e-10)
    np.testing.assert_allclose(var.numpy(), var64[:, None].expand(7, 3)
                               .numpy(), rtol=1e-10)
    np.testing.assert_array_equal(
        mo64.non_dominated(Y).numpy(),
        native.filter_nondominated_host(Y.numpy()).astype(bool))


def test_sound_run_is_correct():
    res = run_small()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def stale_ascent_model(monkeypatch):
    """The refitted model never copied into the model the ascent climbs
    (the graphs' copy keeps the data of its first iteration)."""
    from limbo_tpu_torch.bo import multi
    monkeypatch.setattr(multi, "assign_gp", lambda dst, src: None)


# n = 256: a front inside one bucket, so that the stale model's runs are
# short; its fault shows from a run's second iteration on (the first sees
# the data the stale copy holds)
SHORT_FRONT = dict(SMALL, config=dict(SMALL["config"], n=256, capacity=320))


@pytest.mark.parametrize("fault,caught,overrides", [
    (subsampled_front, "front", SMALL),
    (stale_ascent_model, "post_mean", SHORT_FRONT)])
def test_fault_is_not_correct(monkeypatch, fault, caught, overrides):
    """Three iterations after the set-up, checked as a run is."""
    fault(monkeypatch)
    (rec,) = calibrate.calibrate(CELL, [20261020], 0, units=3, device="cpu",
                                 overrides=overrides)
    correct, checks = run.harness.verdict(
        rec["program"], run.harness.workload(CELL)["limits"])
    assert not correct, checks
    assert checks[caught]["value"] > checks[caught]["limit"]


def test_control_fails_the_limits(monkeypatch):
    monkeypatch.setattr(control, "BLOCK", 64)
    (rec,) = calibrate.calibrate(CELL, [7], 1, units=3, device="cpu",
                                 overrides=SMALL)
    limits = run.harness.workload(CELL)["limits"]
    assert set(rec["control"]) == set(limits) == set(rec["program"])
    assert all(rec["program"][k] <= limits[k] for k in limits), rec
    assert any(rec["control"][k] > limits[k] for k in limits), rec
    assert max(f[0] for f in rec["diag"]["fronts"]) > 64


def test_mo_flops_counts_a_known_iteration():
    """n = 5 points in d = 2, a front of k = 2, one Rprop step, counted by
    hand for p = 2 and 3 objectives: the refit (covariance 60, Cholesky
    40, alpha p x 40), two queries of 2 points (distances 40, L^-1 k 40,
    |v|^2 20, means p x 20), one backward (L^-T 40, means p x 20,
    distances 40) and the boxes ((k + 1)^(p - 1) a candidate, p flops each
    forward, 2 (p - 1) backward)."""
    for p in (2, 3):
        refit = 60 + 40 + p * 40
        query = 40 + 40 + 20 + p * 20
        grad = 40 + p * 20 + 40
        boxes = 2 * 3 ** (p - 1)
        want = (refit + 2 * query + grad + 2 * boxes * p
                + boxes * 2 * (p - 1))
        assert mo_flops.iteration(5, 2, p, 2, 1) == want
        assert mo_flops.refit(5, 2, p) == flops.lml(5, 2) + (p - 1) * 40
