"""The device's work launched under one of the program's spans
(`repro_torch.spans`), for the per-layer readers.

A device event belongs to a span when its launch, on any thread, lies
inside one of the span's intervals on the window's thread: a CUDA
backward launches from autograd's worker thread while the caller's
``train.backward`` is open. Spans of one name do not nest.
"""
from __future__ import annotations

import bisect


def launched_within(rec, name: str) -> tuple:
    """(device seconds, device events, spans) of the events launched
    inside a span `name`; (0.0, 0, spans) where nothing was launched
    there or the record has no device events."""
    spans = rec.spans(name)
    if not spans or not rec.device:
        return 0.0, 0, len(spans)
    starts = [s for s, _ in spans]
    total = events = 0
    for s, e, _, corr, linked in rec.device:
        launch = rec.launches.get(corr) or rec.launches.get(linked)
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch[0]) - 1
        if i >= 0 and spans[i][1] >= launch[0]:
            total += e - s
            events += 1
    return total / 1e9, events, len(spans)
