"""Collective-traffic audit of the sharded pipeline (port of
limbo_tpu/parallel/comm_audit.py).

The reference walks a function's jaxpr and charges every communication
primitive statically (a scan's collectives times its trip count, a cond's
heaviest branch once).  The port is eager, so the audit is made at run
time instead: every collective goes through the wrappers of
``parallel/mesh.py`` (``psum``, ``all_gather``), which report here what
they issue, and ``collective_volume(fn, *args)`` runs ``fn`` once and
returns what it issued.  A loop counts as many times as it ran, and of a
branch only the one taken counts (the deferred flush is charged on the
append that flushes, not on every append).

The numbers are per-rank payloads per CALL, in the reference's cost model:
a ``psum`` of a (B, q) f32 block counts 4 B q bytes (the operand each rank
contributes and receives; a ring all-reduce moves 2 (D - 1) / D of it), an
``all_gather`` counts its gathered output.  docs/BENCHMARKS.md and
tests/test_comm_audit.py give the closed forms of the sharded fit, the
cache build and the append, which tests/test_torch_parallel.py and
chip_smoke.py hold the port to.
"""

from __future__ import annotations

from typing import Dict

import torch

# the statistics of every collective_volume call in progress (innermost
# last); the wrappers of parallel/mesh.py charge each of them
_ACTIVE: list = []


def record(primitive: str, t: torch.Tensor) -> None:
    """Charge one `primitive` whose payload is `t` to every audit in
    progress (called by the collective wrappers, before they issue it)."""
    nbytes = t.numel() * t.element_size()
    for stats in _ACTIVE:
        ent = stats.setdefault(primitive, {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += nbytes


def collective_volume(fn, *args, **kwargs) -> Dict[str, Dict[str, int]]:
    """Per-rank collective payloads of one ``fn(*args, **kwargs)`` call.

    Runs the call (on every rank, as any collective code must) and returns
    {primitive: {"count": n_calls, "bytes": payload_bytes}} for the
    collectives it issued; ``fn``'s own result is dropped (close over a
    list to keep it)."""
    stats: Dict[str, Dict[str, int]] = {}
    _ACTIVE.append(stats)
    try:
        fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()                 # this call's, the innermost
    return stats


def total_bytes(stats: Dict[str, Dict[str, int]]) -> int:
    return sum(e["bytes"] for e in stats.values())
