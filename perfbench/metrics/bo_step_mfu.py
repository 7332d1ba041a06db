"""bo_step_mfu: the needed flops of the window's iterations before the
traced slice (their posterior products and gradients, their appends and
flushes, at the valid n of each: counts/flops.py) over those iterations'
host seconds, as a share of the dense bf16 peak, in % (the configuration
lets the mirror's products run in bf16)."""

from perfbench import harness
from perfbench.counts import flops


def read(ctx):
    recs = harness.before_slice(ctx.records)
    if ctx.trace is None or not recs:
        return None
    c, acq = ctx.cfg, ctx.cfg["acquisition"]
    total = sum(flops.bo_iteration(
        r["n"], c["dim"], acq["restarts"], acq["steps"], acq["sweep"],
        r["pending"], r["flush"], c["cache"]["defer_m"], c["cache"]["lite"])
        for r in recs)
    secs = sum(r["end"] - r["start"] for r in recs)
    return 100.0 * total / secs / flops.PEAK_BF16
