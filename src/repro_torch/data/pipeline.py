"""Synthetic LM data (the reference's `src/repro/data/pipeline.py`).

Two generators, host numpy, bit-equal to the reference's for a seed:
  - ``SyntheticLM``: iid tokens, for throughput runs;
  - ``markov_stream``: an order-1 Markov chain with low-entropy
    transitions, a learnable structure, so example runs show the loss
    fall.

`to_device` puts a host batch on one device; `shard_batch` gives each
process of a mesh its ('batch', 'seq') slice of the global host batch,
as the reference's ``shard_batch`` places a batch on a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        while True:
            tok = rng.integers(0, self.vocab_size,
                               (self.global_batch, self.seq_len + 1), dtype=np.int32)
            yield {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def markov_stream(vocab_size: int, seq_len: int, global_batch: int,
                  seed: int = 0, temperature: float = 0.3) -> Iterator[dict]:
    """Order-1 Markov chain over `vocab_size` states (learnable structure)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (vocab_size, vocab_size)) / max(temperature, 1e-3)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    cumprobs = np.cumsum(probs, axis=-1)
    while True:
        tok = np.zeros((global_batch, seq_len + 1), dtype=np.int32)
        tok[:, 0] = rng.integers(0, vocab_size, global_batch)
        u = rng.random((global_batch, seq_len))
        for t in range(seq_len):
            tok[:, t + 1] = (cumprobs[tok[:, t]] < u[:, t:t + 1]).sum(-1)
        yield {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def to_device(batch: dict, device="cuda") -> dict:
    """A host batch (numpy or tensors) as tensors on `device`; integer
    tokens and labels keep their type (int32 or int64)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(dev) for k, v in batch.items()}


def shard_batch(batch: dict, mesh=None) -> dict:
    """This process's ('batch', 'seq') slice of a global host batch (numpy
    or tensors), on the mesh's device; without a mesh, the whole batch on
    the card (`to_device`)."""
    if mesh is None:
        return to_device(batch)
    from repro_torch.models.sharding import NamedSharding, logical_to_pspec
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        axes = ("batch", "seq") + (None,) * (t.dim() - 2) if t.dim() >= 2 \
            else ("batch",)
        out[k] = NamedSharding(mesh, logical_to_pspec(axes, t.shape,
                                                      mesh)).shard(t)
    return out
