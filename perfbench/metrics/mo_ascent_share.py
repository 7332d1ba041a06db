"""mo_ascent_share: the share of the traced iterations' device-busy time
spent inside the program's ``mo.ascent`` spans (the EHVI's ascent: the
posterior queries of every seed, the exact EHVI and their backward), in
%.  The ascent begins with the card idle (the front's last copies wait
for it) and ends on the proposal's read, so the device's work inside
its spans is the work it launched (spans.py)."""

from perfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    ops = spans.device_ops(ctx.trace)
    wins = spans.windows(ctx.trace, "mo.ascent")
    total = spans.busy_s(ops)
    if not wins or total == 0.0:
        return None
    return 100.0 * spans.busy_s(ops, wins) / total
