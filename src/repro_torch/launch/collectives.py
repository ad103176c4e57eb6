"""The collectives the port issues, and their traffic for the roofline
(the counterpart of ``repro.launch.hlo``).

The reference reads its collectives out of XLA's partitioned HLO text
(``hlo.parse_collectives``: each instruction's buffer bytes, replica-group
size and loop multiplier).  The port runs eager ``torch.distributed``
calls and compiles no program, so there is no text to parse: instead
every collective site of the port reports each call to the active
recorder (:func:`record_collectives`), with its kind, buffer bytes, group
size and site.  The sites: ``sharding._shift`` (``batch_isend_irecv``, a
collective-permute), ``sharding.gather_ranks`` (``all_gather``),
``sharding.count_over_ranks`` (``all_reduce``),
``models.moe_a2a._a2a`` (``all_to_all_single``) and
``train.dp_shardmap`` (``all_reduce`` of the sent gradients and the loss).
With no recorder active a site costs one attribute lookup
(``collectives.RECORDER is not None``).

:class:`Collective` keeps the reference's ring model of the bytes each
device puts on the wire (``hlo.py:68-89``):

* all-gather: O*(g-1)/g       (O = per-device output bytes)
* reduce-scatter: O*(g-1)     (O = per-device scattered output)
* all-reduce: 2*Z*(g-1)/g
* all-to-all: Z*(g-1)/g
* collective-permute: Z

and :func:`collective_summary` the reference's summary schema.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class Collective:
    kind: str
    bytes_buffer: int       # per-device buffer bytes
    group: int
    computation: str        # the port's site that issued it
    multiplier: int = 1     # executions this record stands for

    @property
    def wire_bytes(self) -> float:
        g = max(self.group, 1)
        z = self.bytes_buffer
        if self.kind == "all-gather":
            return z * (g - 1) / g
        if self.kind == "reduce-scatter":
            return z * (g - 1)
        if self.kind == "all-reduce":
            return 2.0 * z * (g - 1) / g
        if self.kind == "all-to-all":
            return z * (g - 1) / g
        return float(z)     # collective-permute


# the active recorder's list, or None (read by every collective site)
RECORDER: Optional[List[Collective]] = None


def note(kind: str, nbytes: int, group: int, site: str) -> None:
    """Add one call to the active recorder (a site calls this only when
    ``RECORDER is not None``)."""
    if RECORDER is not None:
        RECORDER.append(Collective(kind=kind, bytes_buffer=int(nbytes),
                                   group=int(group), computation=site))


@contextlib.contextmanager
def record_collectives():
    """Within the block every collective the port issues in this process
    is appended to the yielded list (a nested block records its own and
    hides them from the outer one)."""
    global RECORDER
    prev, RECORDER = RECORDER, []
    try:
        yield RECORDER
    finally:
        RECORDER = prev


def collective_summary(records: List[Collective]) -> dict:
    """The reference's summary of a step's collectives: wire bytes a
    device in all and by kind, executions by kind, and the number of
    distinct sites."""
    by_kind: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for c in records:
        by_kind[c.kind] = by_kind.get(c.kind, 0.0) \
            + c.wire_bytes * c.multiplier
        count[c.kind] = count.get(c.kind, 0) + c.multiplier
    return {
        "per_device_wire_bytes": sum(by_kind.values()),
        "by_kind_bytes": by_kind,
        "op_counts": count,
        "n_sites": len({(c.kind, c.computation) for c in records}),
    }
