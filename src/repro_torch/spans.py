"""Spans and counters inside the train step and the serving engine, on
`torch.profiler`'s clock.

A span is a `torch.profiler.record_function` while a profiler records in
this process, and one shared no-op context otherwise: no event, no
allocation. The profiler stamps a span as it stamps the kernels, so a
kernel belongs to a span when its launch, on any thread, falls inside
the span (a CUDA backward launches from autograd's worker thread while
the caller's ``train.backward`` is open). Counters add only while a
profiler records.

Spans, and what reads them (``portbench/metrics/``):

- ``train.step``: `core.elastic.ElasticJob.train_step`, the whole call
  (the batch's move, the step, the metrics' host read); the number of
  steps that ``alloc_retries.train`` divides by, and the label of idle
  gaps between the phases below.
- ``train.forward``: `train.loop._backward`, the model's loss of one
  microbatch: ``forward_ms.train``.
- ``train.backward``: `train.loop._backward`, ``loss.backward()`` of one
  microbatch (a remat's recompute included): ``backward_ms.train``.
- ``train.optimizer``: `train.loop.make_train_step`, the gradients'
  average over the microbatches, compression and the update:
  ``optimizer_ms.train``.
- ``serve.prefill``: `serve.engine.ServeEngine.generate`, the prefill,
  its logits gathered and the sync that ends ``prefill_s``:
  ``prefill_ms.serve``.
- ``serve.decode``: each decode step, the token chosen and the sync
  (not the token's readback, not the ``duty`` sleep):
  ``decode_launches.serve``.

Counters (`COUNTS`):

- ``train.alloc_retries``: the gain in the caching allocator's
  ``num_alloc_retries`` over each ``train.step`` on a CUDA device:
  ``alloc_retries.train``.

No name starts with ``cu``: a trace's host events named ``cu*`` are
launches.
"""
from __future__ import annotations

import contextlib

import torch

COUNTS: dict = {}
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context: the profiler's range `name` while it records, else a
    shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n) -> None:
    """Add `n` to ``COUNTS[name]`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        COUNTS[name] = COUNTS.get(name, 0) + n


def reset() -> None:
    COUNTS.clear()
