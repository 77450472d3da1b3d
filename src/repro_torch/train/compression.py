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

On a mesh (``shardings`` given: the trees hold local shards) int8's
per-leaf scale is the whole leaf's max (`sharding.whole_leaf_stats`),
so every process quantizes a leaf on one grid; top-k's whole-leaf
threshold is not ported to a mesh and raises.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import flatten, tree_map, unflatten
from repro_torch.models.sharding import whole_leaf_stats

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

def _q8(g: torch.Tensor, amax=None) -> torch.Tensor:
    """Quantize with scale max|g| / 127 (`amax`: the whole leaf's max|g|,
    where g is a shard) and dequantize."""
    gf = g.to(F32)
    if amax is None:
        amax = torch.max(torch.abs(gf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q.to(F32) * scale


def compress_int8(grads: dict, ef: dict, shardings=None) -> tuple:
    """Returns (decompressed grads, new error-feedback state)."""
    e = dict(flatten(ef))
    gf = {path: g.to(F32) + e[path] for path, g in flatten(grads)}
    amax = [torch.max(torch.abs(g)) for g in gf.values()]
    if shardings is not None:
        sh = dict(flatten(shardings))
        amax = whole_leaf_stats(amax, [sh[p] for p in gf], "max")
    deq = {path: _q8(g, m) for (path, g), m in zip(gf.items(), amax)}
    return (unflatten(grads, deq),
            unflatten(grads, {p: gf[p] - deq[p] for p in gf}))


# ---------------------------------------------------------------------------
# top-k sparsification (per tensor)
# ---------------------------------------------------------------------------

def compress_topk(grads: dict, ef: dict, ratio: float = 0.05,
                  shardings=None) -> tuple:
    """Keep the largest-|g| `ratio` fraction per tensor; error feedback."""
    if shardings is not None:
        raise NotImplementedError("top-k compression takes a whole-leaf "
                                  "threshold, which is not ported to a "
                                  "mesh; use int8 or none")
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
