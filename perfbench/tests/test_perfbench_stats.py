"""The window's statistics, the trace's reduction, the verdict and the
module check, on synthetic inputs."""

import statistics

import pytest

from perfbench import harness


def units(durations, t0=100.0, gap=0.0):
    recs, t = [], t0
    for d in durations:
        recs.append({"start": t, "end": t + d, "latency": d})
        t += d + gap
    return recs


def test_whole_window_rate_counts_a_stall():
    steady = units([0.01] * 100)
    assert harness.rate(steady, 100.0) == pytest.approx(100.0)
    stalled = units([0.01] * 99 + [1.0])
    # the stall lasts past the deadline; the window runs to its end
    assert harness.window_s(stalled, 100.0) == pytest.approx(1.99)
    assert harness.rate(stalled, 100.0) == pytest.approx(100 / 1.99)


def test_rate_counts_time_between_units():
    # a restore between units is inside the window's time
    recs = units([0.01] * 10, gap=0.09)
    assert harness.rate(recs, 100.0) == pytest.approx(10 / 0.91)


def test_end_of_last_unit_begun():
    recs = units([7.0, 7.0, 7.0, 7.5])
    assert harness.seconds_per_unit(recs, 100.0) == pytest.approx(28.5 / 4)
    with pytest.raises(ValueError):
        harness.window_s([], 0.0)


def test_p99_rank():
    xs = list(range(1, 1001))
    # the 990th smallest: ten values lie beyond it
    assert harness.nearest_rank(xs, 0.99) == 990
    assert sum(x > 990 for x in xs) == 10
    assert harness.nearest_rank([5.0], 0.99) == 5.0
    assert harness.nearest_rank([3, 1, 2, 4], 0.5) == 2
    # a stalled iteration among 1,000 steady ones sits beyond the p99
    lat = [0.015] * 999 + [0.9]
    assert harness.nearest_rank(lat, 0.99) == 0.015


def test_spread_matches_statistics_quantiles():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert harness.spread(xs) == pytest.approx((q3 - q1) / med)


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 38)]
    assert harness.union_s(iv) == pytest.approx(30e-9)
    assert harness.gaps(iv, 0, 50) == [(20, 30), (40, 50)]
    assert harness.gaps([], 0, 5) == [(0, 5)]


def test_trace_idle_share_and_breakdown():
    dev = [("k1", 0, 40), ("k2", 30, 60), ("k1", 80, 100)]
    host = [("launch", 55, 90), ("outer", 0, 100)]
    tr = harness.Trace(dev, host, wall_s=200e-9, t0_ns=0, t1_ns=100)
    assert tr.busy_s() == pytest.approx(80e-9)
    assert tr.idle_share() == pytest.approx(0.6)
    bd = tr.breakdown(short_ns=5)
    assert bd["device_ops"][0] == ["k1", pytest.approx(60e-9)]
    # the gap 60..80 is named by the innermost host operation at 70
    assert bd["idle_gaps"] == [["launch", pytest.approx(20e-9)]]
    # gaps shorter than the launch latency are summed apart
    assert tr.breakdown(short_ns=50)["idle_gaps"] == [
        ["(gaps under 0 us)", pytest.approx(20e-9)]]


def test_idle_share_reads_kernels_from_the_trace_and_units_from_the_run():
    tr = harness.Trace([("k", 0, 8_000_000)], [], wall_s=0.02, t0_ns=0,
                       t1_ns=8_000_000)
    recs = units([0.010] * 3) + [dict(r, traced=True) for r in units(
        [0.020], t0=200.0)]
    for r in recs:
        r.setdefault("traced", False)
    # 8 ms busy in the one traced unit, 10 ms a unit untraced: 20% idle
    assert harness.idle_share(tr, recs) == pytest.approx(20.0)
    assert harness.idle_share(None, recs) is None
    assert harness.idle_share(tr, [r for r in recs if r["traced"]]) is None


def test_verdict():
    ok, checks = harness.verdict({"a": 1.0, "b": 2.0}, {"a": 1.0, "b": 3.0})
    assert ok and checks["b"] == {"value": 2.0, "limit": 3.0}
    assert not harness.verdict({"a": 1.1}, {"a": 1.0})[0]
    assert not harness.verdict({"a": float("nan")}, {"a": 1.0})[0]
    assert not harness.verdict({"a": 0.5}, {"a": 1.0, "b": 1.0})[0]


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"limbo_tpu_torch": 0, "limbo_tpu_torch.models": 0,
            "jaxtyping": 0, "torch": 0}
    assert harness.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 0, "limbo_tpu.models": 0, "flax": 0,
                 "jaxlib": 0})
    assert harness.forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib",
                                               "limbo_tpu.models"]


def test_process_age_is_positive():
    assert 0.0 < harness.process_age_s() < 1e6
