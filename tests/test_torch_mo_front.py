"""The Ehvi loop holds the observed front whole: the port's acquisition over
a front of more than 64 points against the benchmark's plain float64
reference (perfbench/reference/mo64.py: an exact GP per objective and the
exact 3-D EHVI by the full grid of cells), every Pareto point a seed of
the ascent, the padded arrays of a front of at most 64 points as they
were, and one ``Ehvi.iterate`` at DTLZ2's published width (d = 12) with
its spans and counters; on a card, the ascent's CUDA graphs against the
eager ascent, with 3 objectives and with 2.

Everything else runs on the CPU in float64.  Tolerances: 1e-10 relative for
the EHVI and the posterior (two exact computations that sum in other
orders; the GP's factor has a condition number near 1e4 here); the front
and the seeds exactly.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from limbo_tpu_torch.bo import multi
from limbo_tpu_torch.bo.multi import Ehvi
from limbo_tpu_torch.opt.gradient import Rprop

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.reference import mo64  # noqa: E402

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
REF = (-1.1, -1.1, -1.1)


def dtlz2(x):
    return mo64.dtlz2(torch.as_tensor(x, dtype=torch.float64)[None])[0] \
        .numpy()


def loop_on(X, **kw):
    """An f64 Ehvi loop holding X and DTLZ2 at X."""
    loop = Ehvi(ref=REF, **F64, **kw)
    loop.X = list(X)
    loop.Y = list(mo64.dtlz2(torch.as_tensor(X)).numpy())
    return loop


def reference(loop, Q):
    """mo64's posterior at Q over the loop's data, at the loop's kernel
    parameters, and its EHVI over the whole front."""
    k = loop.kernel
    X = torch.as_tensor(np.stack(loop.X))
    Y = torch.as_tensor(np.stack(loop.Y))
    gp = mo64.GP(X, Y, float(torch.exp(k.log_l)),
                 float(torch.exp(2 * k.log_sigma)),
                 float(torch.exp(2 * k.log_noise)), 1e-8)
    mu, var = gp.posterior(Q, X.shape[0])
    sigma = torch.sqrt(var.clamp(min=1e-20))[:, None].expand_as(mu)
    front = Y[mo64.non_dominated(Y)]
    return mu, var, mo64.ehvi3(mu, sigma, front, REF), front


class Recorded(Rprop):
    """Rprop keeping the starts of its latest ascent."""

    def __call__(self, fun, init, generator=None, bounded=False):
        self.starts = init.clone()
        return super().__call__(fun, init, generator, bounded)


def test_acquisition_over_a_long_front_equals_reference():
    X = np.random.default_rng(3).uniform(size=(256, 3))
    loop = loop_on(X)
    loop.update_models(capacity=256)
    fx, fy, fm = loop.padded_front(3)
    k = int(fm.sum())
    assert k > multi.FRONT_CAP and fx.shape[0] == 2 * multi.FRONT_CAP
    Q = torch.as_tensor(np.random.default_rng(4).uniform(size=(9, 3)))
    got = loop.acquisition(loop.model, fy, fm)(Q)
    _, _, want, front = reference(loop, Q)
    assert front.shape[0] == k
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)
    assert float(want.min()) > 0.0


def test_every_pareto_point_seeds_the_ascent():
    X = np.random.default_rng(5).uniform(size=(256, 3))
    opt = Recorded(iterations=0)
    loop = loop_on(X, inner_opt=opt)
    loop.iterate(dtlz2, 3, torch.Generator().manual_seed(0), 320)
    Y = torch.as_tensor(np.stack(loop.Y[:256]))
    P = torch.as_tensor(X)[mo64.non_dominated(Y)]
    k = P.shape[0]
    assert k > multi.FRONT_CAP
    assert multi.COUNTERS == {"front": k, "front_cap": 2 * multi.FRONT_CAP,
                              "boxes": (2 * multi.FRONT_CAP + 1) ** 2,
                              "seeds": 2 * multi.FRONT_CAP,
                              "ascent_steps": 0, "captured": 0}
    assert opt.starts.shape == (2 * multi.FRONT_CAP, 3)
    seeds = {tuple(r) for r in opt.starts[:k].tolist()}
    assert seeds == {tuple(r) for r in P.tolist()}
    assert not opt.starts[k:].any()


@pytest.mark.parametrize("k,cap", [(5, 64), (64, 64), (65, 128)])
def test_front_buckets_and_short_fronts_pad_as_before(k, cap):
    """k points on the sphere (mutually non-dominated) and k farther out
    (each dominated by its twin): the front is the k, in their order,
    padded to cap rows; at k <= 64 the arrays the loop always built (64
    rows: the points, then zeros / the reference point / a zero mask)."""
    rng = np.random.default_rng(k)
    u = rng.uniform(0.1, 1.4, size=(k, 2))
    S = np.stack([np.cos(u[:, 0]) * np.cos(u[:, 1]),
                  np.cos(u[:, 0]) * np.sin(u[:, 1]), np.sin(u[:, 0])], 1)
    X = rng.uniform(size=(2 * k, 4))
    loop = Ehvi(ref=REF, **F64)
    loop.X, loop.Y = list(X), list(np.concatenate([-S, -1.5 * S]))
    fx, fy, fm = loop.padded_front(4)
    want_x = np.zeros((cap, 4))
    want_x[:k] = X[:k]
    want_y = np.tile(REF, (cap, 1))
    want_y[:k] = -S
    want_m = (np.arange(cap) < k).astype(np.float64)
    assert torch.equal(fx, torch.as_tensor(want_x))
    assert torch.equal(fy, torch.as_tensor(want_y))
    assert torch.equal(fm, torch.as_tensor(want_m))
    assert (multi.COUNTERS["front"], multi.COUNTERS["front_cap"]) == (k, cap)


def test_iterate_at_the_published_width_equals_reference():
    """One iteration on DTLZ2 at d = 12: the proposal's EHVI value and
    posterior against mo64 over the data the iteration saw, DTLZ2 at the
    proposal appended, the four spans in order, the counters."""
    X = np.random.default_rng(6).uniform(size=(160, 12))
    loop = loop_on(X, inner_opt=Rprop(iterations=4))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x, value = loop.iterate(dtlz2, 12, torch.Generator().manual_seed(0),
                                192)
    spans = sorted((e.start_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("mo."))
    assert [n for _, n in spans] == ["mo.refit", "mo.front", "mo.ascent",
                                     "mo.eval"]
    assert loop.iteration == 1 and len(loop.X) == 161
    np.testing.assert_array_equal(loop.X[-1], x)
    np.testing.assert_allclose(loop.Y[-1], dtlz2(x), rtol=1e-15)
    loop.X, loop.Y = loop.X[:160], loop.Y[:160]
    Q = torch.as_tensor(x)[None]
    mu64, var64, e64, front = reference(loop, Q)
    mu, var = multi.multi_gp.query(loop.model, Q)
    np.testing.assert_allclose(mu.numpy(), mu64.numpy(), rtol=1e-10)
    np.testing.assert_allclose(var.numpy()[:, 0], var64.numpy(), rtol=1e-10)
    np.testing.assert_allclose(float(value), float(e64[0]), rtol=1e-10)
    k = front.shape[0]
    assert multi.COUNTERS["front"] == k and multi.COUNTERS[
        "ascent_steps"] == 4


def mop2(X):
    """mop2 (2 objectives, maximized as -f) at the rows of X, [0, 1]^d
    mapped to [-2, 2]^d."""
    X = 4.0 * X - 2.0
    c = 1.0 / np.sqrt(X.shape[1])
    return np.stack([np.exp(-((X - c) ** 2).sum(1)),
                     np.exp(-((X + c) ** 2).sum(1))], 1) - 1.0


@pytest.mark.cuda
def test_captured_ascent_replays_the_eager_one():
    """On the card: in f32 with 3 objectives (the box decomposition), four
    ascents over the data of 256, 200, 40 and 30 points of DTLZ2, whose
    fronts fill the 128-row bucket, then the 64-row one; in f64 with 2
    objectives (the stripe sum, ehvi2d), three ascents over 256, 200 and
    100 points of mop2, all in the 64-row bucket.  Each bucket's graph is
    captured at its first ascent (which must not wait on the card) and
    replayed at the next, over the new model copied into it, and every
    proposal and value equal the eager ascent's over the same model and
    front."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the ascent's CUDA graphs)")
    X = np.random.default_rng(5).uniform(size=(256, 3))
    cases = [(REF, torch.float32, lambda x: mo64.dtlz2(torch.as_tensor(x))
              .numpy(), (256, 200, 40, 30), [128, 128, 64, 64], [1, 0, 1, 0],
              dict(rtol=1e-6, atol=1e-7)),
             ((-1.1, -1.1), torch.float64, mop2, (256, 200, 100),
              [64, 64, 64], [1, 0, 0], {})]
    for ref, dtype, f, sizes, want_caps, want_captured, tol in cases:
        loop = Ehvi(ref=ref, inner_opt=Rprop(iterations=5),
                    device=torch.device("cuda", 0), dtype=dtype)
        caps, captured = [], []
        for n in sizes:
            loop.X, loop.Y = list(X[:n]), list(f(X[:n]))
            loop.update_models(capacity=320)
            fx, fy, fm = loop.padded_front(3)
            want = loop.step(loop.model, fy, fm, fx)
            got = loop._ascent()(loop.model, fy, fm, fx)
            torch.testing.assert_close(got, want, **tol)
            caps.append(fx.shape[0])
            captured.append(multi.COUNTERS["captured"])
        assert (caps, captured) == (want_caps, want_captured)
