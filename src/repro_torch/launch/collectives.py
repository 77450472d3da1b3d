"""Collective bytes of a sharded step (the counterpart of the reference's
`src/repro/launch/hlo_analysis.py`).

The reference parses the XLA HLO text of a compiled step for its
collectives. The port has no HLO: a sharded step issues its collectives
itself (`repro_torch.models.sharding`), so `COUNTER` records each one as
it is issued, with its kind, its result bytes and its group size, and
nothing has to be parsed. XLA HLO parsing is therefore not ported; the
dtype table, `_shape_bytes` (bytes of an HLO type string) and the ring
cost model `_wire_bytes` are the reference's, so both packages turn one
collective into the same bytes on the wire:

  all-reduce         2·b·(n−1)/n      (b the buffer)
  all-gather         b·(n−1)/n        (b the gathered result)
  reduce-scatter     b·(n−1)          (b the scattered shard)
  all-to-all         b·(n−1)/n
  collective-permute b

`COUNTER` counts only inside ``with COUNTER.on():``; elsewhere a
collective pays for one attribute read and records nothing, so timed
steps compute no accounting. `CollectiveCounter.summary` gives the
total wire bytes per device, by kind: the numerator of the roofline's
``collective_s`` (`repro_torch.launch.roofline.collective_seconds`).
A collective over a group of one device is not issued and not counted.
"""
from __future__ import annotations

import contextlib
import re

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(type_str: str) -> int:
    """Bytes of an HLO result type (handles tuples)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _wire_bytes(kind: str, result_bytes: int, n: int) -> float:
    """Ring-algorithm bytes moved per participating device."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if kind == "all-gather":
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return float(result_bytes) * (n - 1)   # result is the scattered shard
    if kind == "all-to-all":
        return result_bytes * (n - 1) / n
    if kind == "collective-permute":
        return float(result_bytes)
    return 0.0


class CollectiveCounter:
    """The collectives issued inside `on()`: (kind, result bytes, group
    size) each, in issue order, as seen by this process (one device)."""

    def __init__(self):
        self.enabled = False
        self.records: list = []

    def reset(self):
        self.records = []

    @contextlib.contextmanager
    def on(self):
        """Record the collectives issued inside this block."""
        before, self.enabled = self.enabled, True
        try:
            yield self
        finally:
            self.enabled = before

    def record(self, kind: str, result_bytes: int, n: int):
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective {kind!r}")
        self.records.append((kind, int(result_bytes), int(n)))

    def summary(self) -> dict:
        """{"per_kind": {kind: {"count", "result_bytes", "wire_bytes"}},
        "total_wire_bytes"}: the reference's `analyze_collectives` record,
        wire bytes per device."""
        per_kind = {}
        for kind, nbytes, n in self.records:
            row = per_kind.setdefault(kind, {"count": 0, "result_bytes": 0,
                                             "wire_bytes": 0.0})
            row["count"] += 1
            row["result_bytes"] += nbytes
            row["wire_bytes"] += _wire_bytes(kind, nbytes, n)
        return {"per_kind": per_kind,
                "total_wire_bytes": sum(r["wire_bytes"]
                                        for r in per_kind.values())}


COUNTER = CollectiveCounter()
