"""Device time by the program's torch.profiler spans (``record_function``)
in a traced slice.

A span is a host operation of the trace under its name.  The device time
of a span is the union of the device's operations clipped to the span's
windows on the trace's one clock: where a span begins with the device
idle and ends on a read that waits for it, that is the work it launched.
On the card the profiler repeats each span as a device-side annotation
under the same name; a device operation named as a host operation is such
an annotation, not work, and is left out of every sum here.
"""

from __future__ import annotations

from perfbench import harness


def windows(trace, name: str) -> list:
    """(start, end) in ns of every host span called ``name``."""
    return sorted((s, e) for n, s, e in trace.host_ops if n == name)


def device_ops(trace) -> list:
    """The trace's device operations (name, start, end) but the spans'
    annotations."""
    host = {n for n, _, _ in trace.host_ops}
    return [op for op in trace.device_ops if op[0] not in host]


def busy_s(ops, wins=None) -> float:
    """Seconds in the union of the operations, clipped to the (start, end)
    windows where given."""
    spans = [(s, e) for _, s, e in ops]
    if wins is not None:
        spans = [(max(s, a), min(e, b)) for s, e in spans for a, b in wins
                 if s < b and e > a]
    return harness.union_s(spans)


def idle_share(trace, records) -> float | None:
    """harness.idle_share with the spans' annotations left out of the
    device's busy time, in %."""
    traced = [r for r in records if r["traced"]]
    plain = harness.before_slice(records)
    if trace is None or not traced or not plain:
        return None
    ops = device_ops(trace)
    if not ops:
        return None
    busy = busy_s(ops) / len(traced)
    unit = sum(r["end"] - r["start"] for r in plain) / len(plain)
    return 100.0 * (1.0 - busy / unit)
