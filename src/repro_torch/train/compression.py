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
so every process quantizes a leaf on one grid; top-k's threshold is the
whole leaf's k-th largest |g| by an exact distributed selection
(`_whole_leaf_kth`), so every process keeps exactly the entries the
unsharded rule keeps.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.params import flatten, tree_map, unflatten
from repro_torch.models.sharding import (all_gather, spec_axes,
                                         whole_leaf_stats)

F32 = torch.float32


def ef_init(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


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

def _whole_leaf_kth(mag: torch.Tensor, k: int, sharding) -> torch.Tensor:
    """The k-th largest entry of a whole leaf of magnitudes, given this
    process's shard `mag` and its `NamedSharding`. Each shard offers its
    top min(k, shard numel) values; these are all-gathered over the axes
    that split the leaf (replicas along the other axes hold the same
    shard and are not gathered twice). Every entry of the whole leaf's
    top k is in its own shard's top k, so the k-th largest of the union
    is the whole leaf's: the same value, exactly."""
    flat = mag.reshape(-1)
    cand = torch.topk(flat, min(k, flat.shape[0])).values
    for entry in sharding.spec:
        for a in spec_axes(entry):
            cand = all_gather(cand, 0, sharding.mesh, a)
    return torch.topk(cand, k).values[-1]


def compress_topk(grads: dict, ef: dict, ratio: float = 0.05,
                  shardings=None) -> tuple:
    """Keep the largest-|g| `ratio` fraction per tensor; error feedback.
    On a mesh (`shardings`: the leaves' `NamedSharding`s, the trees
    local shards) k counts the whole leaf's entries and the threshold is
    the whole leaf's (`_whole_leaf_kth`)."""
    sh = dict(flatten(shardings)) if shardings is not None else {}
    e = dict(flatten(ef))
    out = {}
    for path, g in flatten(grads):
        gf = g.to(F32) + e[path]
        mag = torch.abs(gf)
        if path in sh:
            numel = math.prod(gf.shape) * math.prod(
                sh[path].mesh.size(a) for x in sh[path].spec
                for a in spec_axes(x))
            thresh = _whole_leaf_kth(mag, max(1, int(numel * ratio)),
                                     sh[path])
        else:
            k = max(1, int(gf.numel() * ratio))
            thresh = torch.topk(mag.reshape(-1), k).values[-1]
        kept = torch.where(mag >= thresh, gf, 0.0)
        out[path] = (kept, gf - kept)
    return (unflatten(grads, {k: o[0] for k, o in out.items()}),
            unflatten(grads, {k: o[1] for k, o in out.items()}))


def wire_bytes_ratio(scheme: str, topk_ratio: float = 0.05) -> float:
    """Bytes-on-the-wire ratio vs f32 all-reduce (for roofline accounting)."""
    if scheme == "int8":
        return 0.25
    if scheme == "topk":
        return topk_ratio * 2.0     # value + index per kept entry
    return 1.0
