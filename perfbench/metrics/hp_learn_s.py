"""hp_learn_s: seconds per learning: from the window's start to the end of
the last learning begun inside it, over the learnings, host clock."""

from perfbench import harness


def read(ctx):
    return harness.seconds_per_unit(ctx.records, ctx.t_start)
