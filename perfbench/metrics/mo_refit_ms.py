"""mo_refit_ms: the device's busy milliseconds an iteration from the start
of the program's ``mo.refit`` span (one GP per objective refitted: the
training covariance, the Cholesky factor, alpha) to the end of the
``mo.front`` span after it.  The refit's last solves run on while the
front's first copy waits for them, so the window holds the front's
dominance test too (comparisons over the observed points: about 1 ms of
the window's ~10 on an H100, PERF.md)."""

from perfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    fronts = spans.windows(ctx.trace, "mo.front")
    wins = []
    for s, _ in spans.windows(ctx.trace, "mo.refit"):
        after = [e for fs, e in fronts if fs >= s]
        if after:
            wins.append((s, min(after)))
    if not wins:
        return None
    ops = spans.device_ops(ctx.trace)
    if not ops:
        return None
    return 1e3 * spans.busy_s(ops, wins) / len(wins)
