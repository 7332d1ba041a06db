"""bo_iters_per_s: BO iterations completed in the window over the window,
from its start to the end of the last iteration begun inside it (restores
of the state included), host clock."""

from perfbench import harness


def read(ctx):
    return harness.rate(ctx.records, ctx.t_start)
