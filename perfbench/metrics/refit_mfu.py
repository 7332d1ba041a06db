"""refit_mfu: the needed flops of the window's refits before the traced
slice (the fit's covariance, Cholesky and solves; the build's L^-1,
mirror and two passes over Linv: counts/flops.py) over those refits' host
seconds, as a share of the dense TF32 peak, in %."""

from perfbench import harness
from perfbench.counts import flops


def read(ctx):
    recs = harness.before_slice(ctx.records)
    if ctx.trace is None or not recs:
        return None
    n, d = ctx.cfg["n"], ctx.cfg["dim"]
    secs = sum(r["end"] - r["start"] for r in recs)
    return 100.0 * len(recs) * flops.refit(n, d) / secs / flops.PEAK_TF32
