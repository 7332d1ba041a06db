"""hp_step_mfu: the needed flops of the window's learnings before the
traced slice (every LML + its gradient, every LML alone and the refit
that ends a learning, at the valid n: counts/flops.py) over those
learnings' host seconds, as a share of the dense TF32 peak (the fastest
rate at which the card multiplies f32 operands), in %."""

from perfbench import harness
from perfbench.counts import flops


def read(ctx):
    recs = harness.before_slice(ctx.records)
    if ctx.trace is None or not recs:
        return None
    n, d = ctx.cfg["n"], ctx.cfg["dim"]
    total = sum(r["graded"] * flops.lml_grad(n, d)
                + (r["values"] + 1) * flops.lml(n, d) for r in recs)
    secs = sum(r["end"] - r["start"] for r in recs)
    return 100.0 * total / secs / flops.PEAK_TF32
