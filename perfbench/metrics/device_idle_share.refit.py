"""device_idle_share.refit: the share of a refit in which no kernel or copy
runs on the card, in %: 1 - the traced units' device-busy seconds (the
union of the device's operations) a unit over the host seconds a unit of
the units before the slice (harness.idle_share)."""

from perfbench import harness


def read(ctx):
    return harness.idle_share(ctx.trace, ctx.records)
