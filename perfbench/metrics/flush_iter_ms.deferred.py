"""flush_iter_ms.deferred: the median latency of the window's iterations
whose append flushed the pending pivots into the f32 K^-1 and its mirror
(before the traced slice), host clock, ms."""

import statistics

from perfbench import harness


def read(ctx):
    ms = [1e3 * r["latency"] for r in harness.before_slice(ctx.records)
          if r["flush"]]
    return statistics.median(ms) if ms else None
