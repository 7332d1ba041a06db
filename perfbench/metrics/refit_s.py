"""refit_s: seconds per refit (the fit and the cache build): from the
window's start to the end of the last refit begun inside it, over the
refits, host clock."""

from perfbench import harness


def read(ctx):
    return harness.seconds_per_unit(ctx.records, ctx.t_start)
