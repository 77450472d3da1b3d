"""Collective bytes of a sharded step (the counterpart of the reference's
`src/repro/launch/hlo_analysis.py`).

The reference parses the XLA HLO text of a compiled step for its
collectives. The port has no HLO: a sharded step issues its collectives
itself (`repro_torch.models.sharding`), so `COUNTER` records each one as
it is issued, with its kind, its result bytes, its group size, its mesh
axis and the stride of its group in the mesh's row-major rank order (so
the roofline can tell a group inside one host from one across hosts),
and nothing has to be parsed. An abstract mesh (`sharding.Mesh.abstract`)
records the same collectives without issuing them. XLA HLO parsing is therefore not ported; the
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
total wire bytes per device, by kind (the reference's record) and by
mesh axis: the numerators of the roofline's ``collective_s``
(`repro_torch.launch.roofline`).
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
    size, mesh axis, group stride) each, in issue order, as seen by this
    process (one device)."""

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

    def record(self, kind: str, result_bytes: int, n: int, axis=None,
               stride: int = 0):
        """One collective; `axis` None and `stride` 0 where the caller
        does not know them."""
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective {kind!r}")
        self.records.append((kind, int(result_bytes), int(n), axis,
                             int(stride)))

    def summary(self) -> dict:
        """{"per_kind": {kind: {"count", "result_bytes", "wire_bytes"}},
        "per_axis": {axis: {"count", "result_bytes", "wire_bytes", "n",
        "stride", and each kind's wire bytes}}, "total_wire_bytes"}: the
        reference's `analyze_collectives` record and the same bytes by
        mesh axis, wire bytes per device."""
        per_kind, per_axis = {}, {}
        for kind, nbytes, n, axis, stride in self.records:
            wire = _wire_bytes(kind, nbytes, n)
            axis_row = per_axis.setdefault(str(axis), {"n": n,
                                                       "stride": stride})
            for row in (per_kind.setdefault(kind, {}), axis_row):
                row["count"] = row.get("count", 0) + 1
                row["result_bytes"] = row.get("result_bytes", 0) + nbytes
                row["wire_bytes"] = row.get("wire_bytes", 0.0) + wire
            axis_row[kind] = axis_row.get(kind, 0.0) + wire
        return {"per_kind": per_kind, "per_axis": per_axis,
                "total_wire_bytes": sum(r["wire_bytes"]
                                        for r in per_kind.values())}


COUNTER = CollectiveCounter()
