"""mo_step_mfu: the needed flops of the window's Ehvi iterations before the
traced slice (the refit, the ascent's posterior products and their
gradients over the front's seeds, the EHVI's box products:
counts/mo_flops.py, at each iteration's n and front size from the
program's counters) over those iterations' host seconds, as a share of
the dense TF32 peak (the fastest rate at which the card multiplies f32
operands), in %."""

from perfbench import harness
from perfbench.counts import flops, mo_flops


def read(ctx):
    recs = harness.before_slice(ctx.records)
    if ctx.trace is None or not recs:
        return None
    c = ctx.cfg
    total = sum(mo_flops.iteration(r["n"], c["dim"], c["n_objs"],
                                   r["front"], r["ascent_steps"])
                for r in recs)
    secs = sum(r["end"] - r["start"] for r in recs)
    return 100.0 * total / secs / flops.PEAK_TF32
