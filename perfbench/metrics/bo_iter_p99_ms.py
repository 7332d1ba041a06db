"""bo_iter_p99_ms: the 99th percentile (nearest rank) of all the window's
iterations, each from the call of BOStep.step() to its proposal on the
host, host clock."""

from perfbench import harness


def read(ctx):
    return 1e3 * harness.nearest_rank([r["latency"] for r in ctx.records],
                                      0.99)
