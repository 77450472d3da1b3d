"""Gradient compression with error feedback (the reference's
`src/repro/train/compression.py`).

A value-level quantize → dequantize of the gradients before the
optimizer, which models the numerics of a compressed all-reduce; the
byte saving on the wire is the analytic `wire_bytes_ratio`. Both
schemes keep error-feedback state so that the compression error is
re-injected next step. The rules are the reference's exactly: int8
rounds half to even (``torch.round``, as ``jnp.round``); top-k keeps
every entry with |g| at or above the k-th largest |g|, so a tie at the
threshold keeps all the tied entries.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import flatten, tree_map, unflatten

F32 = torch.float32


def ef_init(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def _per_leaf(one, grads, ef) -> tuple:
    e = dict(flatten(ef))
    out = {path: one(g, e[path]) for path, g in flatten(grads)}
    return (unflatten(grads, {k: o[0] for k, o in out.items()}),
            unflatten(grads, {k: o[1] for k, o in out.items()}))


# ---------------------------------------------------------------------------
# int8 per-tensor quantization
# ---------------------------------------------------------------------------

def _q8(g: torch.Tensor) -> torch.Tensor:
    gf = g.to(F32)
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q.to(F32) * scale


def compress_int8(grads: dict, ef: dict) -> tuple:
    """Returns (decompressed grads, new error-feedback state)."""
    def one(g, e):
        gf = g.to(F32) + e
        deq = _q8(gf)
        return deq, gf - deq
    return _per_leaf(one, grads, ef)


# ---------------------------------------------------------------------------
# top-k sparsification (per tensor)
# ---------------------------------------------------------------------------

def compress_topk(grads: dict, ef: dict, ratio: float = 0.05) -> tuple:
    """Keep the largest-|g| `ratio` fraction per tensor; error feedback."""
    def one(g, e):
        gf = g.to(F32) + e
        flat = gf.reshape(-1)
        k = max(1, int(flat.shape[0] * ratio))
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        kept = torch.where(torch.abs(gf) >= thresh, gf, 0.0)
        return kept, gf - kept
    return _per_leaf(one, grads, ef)


def wire_bytes_ratio(scheme: str, topk_ratio: float = 0.05) -> float:
    """Bytes-on-the-wire ratio vs f32 all-reduce (for roofline accounting)."""
    if scheme == "int8":
        return 0.25
    if scheme == "topk":
        return topk_ratio * 2.0     # value + index per kept entry
    return 1.0
