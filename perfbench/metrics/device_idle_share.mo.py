"""device_idle_share.mo: the share of an Ehvi iteration in which no kernel
or copy runs on the card, in %: 1 - the traced iterations' device-busy
seconds (the union of the device's operations, the program's spans'
device-side annotations left out) a unit over the host seconds a unit of
the units before the slice that held their front at as many rows (the
first iterations of a run hold a longer front, and take up to twice as
long: spans.idle_share)."""

from perfbench import spans


def read(ctx):
    rows = {r["front_cap"] for r in ctx.records if r["traced"]}
    return spans.idle_share(ctx.trace, [r for r in ctx.records
                                        if r["front_cap"] in rows])
