"""Layers on local shards, shared by the five families' mesh paths
(`transformer`, `mamba2`, `rglru`, `encdec`).

The reference hands its model code to GSPMD, which partitions it from
the `constrain` points and the parameters' logical axes. The port runs
the same layouts by hand (`repro_torch.models.sharding`): each process
holds its shard of every parameter (`Model.shardings`) and of the batch
rows, and the pieces here move activations between layouts with
explicit collectives whose backward is the conjugate collective.

- `Layout`: the layouts of one step on a mesh for a global (B, S)
  batch: the residual stream's logical axes and the mesh axes that
  split the heads, d_ff and the vocabulary where a layer runs tensor-
  parallel; `Layout.weight` gathers a weight as a layer uses it and
  `Layout.norm` applies a norm (RMS, or layer norm with its bias) with
  its replicated parameters.
- `attention_block` and `mlp_block`: a pre-norm residual block of
  attention on the local heads (the flash kernel on the card) and of the
  MLP on the local d_ff.
- `embed`, `loss_head` and `last_logits`: the vocabulary-parallel
  embedding, the chunked cross-entropy with the log-sum-exp and the
  label's logit summed over the vocabulary axis and this process's
  share of the loss, and the last position's logits laid out ("batch",
  "tp").
- `split_decode_attention`: one query token against this process's
  cache slots, the others' on the mesh axes that split them (flash-
  decoding): causal over the slots' absolute positions (a ring cache
  passes its own), or non-causal (cross-attention over the encoder's
  slots).
- `sum_over`: a sum of partial values over mesh axes whose consumers
  differ by process, all-reduced in the forward and in the backward.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import layers as L
from repro_torch.models.params import DTYPES, flatten, param_pspecs
from repro_torch.models.sharding import (all_reduce, constrain,
                                         logical_to_pspec, redistribute,
                                         shard_range, spec_axes, use_weight)

FULL = ("batch", "seq", None)      # a layer's input, its sequence whole


class Layout:
    """The model's layouts on a mesh for a global (B, S) batch, from the
    reference's `constrain` points: the residual stream's logical axes
    (`res`: `L.residual_axes` in training, whole in serving; `sp` the
    axes that split its sequence) and the mesh axes that split the heads
    (q and k, ("batch", "seq", "tp", None)), d_ff and the vocabulary
    (("batch", "seq", "tp")) where the layer runs tensor-parallel, each
    empty where the rules drop them."""

    def __init__(self, cfg: ModelConfig, mesh, B: int, S: int, res=None):
        d = cfg.d_model
        tp = lambda n: spec_axes(mesh.pspec(  # noqa: E731
            ("batch", "seq", "tp"), (B, S, n))[2])
        q = spec_axes(mesh.pspec(("batch", "seq", "tp", None),
                                 (B, S, cfg.n_heads, cfg.head_dim))[2])
        k = spec_axes(mesh.pspec(("batch", "seq", "tp", None),
                                 (B, S, cfg.n_kv_heads, cfg.head_dim))[2])
        self.cfg, self.mesh, self.shape = cfg, mesh, (B, S, d)
        self.res = res or L.residual_axes(cfg)
        self.sp = spec_axes(mesh.pspec(self.res, self.shape)[1])
        self.heads = q if q == k else ()
        self.ff = tp(cfg.d_ff)
        self.vocab = tp(cfg.vocab_size)
        self.n_heads = cfg.n_heads // self.shards(self.heads)
        self.n_kv_heads = cfg.n_kv_heads // self.shards(self.heads)
        self.dtype = DTYPES[cfg.dtype] if cfg.cast_weights else None

    def shards(self, axes) -> int:
        return math.prod(self.mesh.size(a) for a in axes)

    def to(self, x, logical, src, partial=(), grad_partial=()):
        """`constrain` of a (B, S, d) tensor from layout `src`."""
        return constrain(x, logical, self.mesh, src=src, shape=self.shape,
                         partial=partial, grad_partial=grad_partial)

    def weight(self, t, spec, keep=(), partial=(), dtype=None):
        """A weight as the layer uses it: gathered over every axis of its
        storage spec but `keep`, cast to `dtype`; its gradient summed
        over the axes whose processes hold distinct data (the batch
        axes and `partial`)."""
        return use_weight(t, spec, self.mesh, keep,
                          self.mesh.batch + tuple(partial), dtype)

    def layer_weights(self, lp: dict, specs: dict):
        """``w(path, keep=(), partial=())``: a weight of the layer (flat
        dicts of tensors and their PartitionSpecs) as it runs, in the
        activation dtype with ``cast_weights``."""
        return lambda path, keep=(), partial=(): self.weight(
            lp[path], specs[path], keep, partial, self.dtype)

    def norm(self, x, lp: dict, specs: dict, name: str, partial=()):
        """`L.apply_norm` of the layer's norm `name`: its scale (and a
        layer norm's bias), replicated, as the layer uses them; their
        gradients summed over `partial` too."""
        w = self.layer_weights(lp, specs)
        p = {k: w(f"{name}/{k}", partial=partial) for k in ("scale", "bias")
             if f"{name}/{k}" in lp}
        return L.apply_norm(x, p, self.cfg.norm_eps)

    def local_cfg(self) -> ModelConfig:
        """The config with this process's head counts."""
        return dataclasses.replace(self.cfg, n_heads=self.n_heads,
                                   n_kv_heads=self.n_kv_heads)

    def whole_heads(self, t):
        """(B, S, H_local, Dh) on the local heads -> every head."""
        return redistribute(t, (None, None, self.heads or None, None),
                            (None,) * 4, self.mesh)

    def local_heads(self, t):
        """(B, S, H, Dh) -> this process's heads."""
        return redistribute(t, (None,) * 4,
                            (None, None, self.heads or None, None), self.mesh)

    def seq_chunk(self, t):
        """This process's chunk of a (S, ...) tensor along the residual
        layout's sequence."""
        entry = self.mesh.pspec(self.res, self.shape)[1]
        return t.narrow(0, *shard_range(entry, t.shape[0], self.mesh))


def sum_over(x, mesh, axes):
    """The sum over `axes` of partial values `x` whose consumers differ
    by process (each normalises its own channels with the total): all-
    reduced in the forward, and the gradient all-reduced in the backward
    (each process's consumers give a partial gradient of the total)."""
    x = redistribute(x, (), (), mesh, grad_partial=axes)
    return redistribute(x, (), (), mesh, partial=axes)


# ---------------------------------------------------------------------------
# Residual blocks
# ---------------------------------------------------------------------------

def attention_block(cfg: ModelConfig, lay: Layout, specs: dict, x, lp: dict,
                    positions, attn_fn=None, ln: str = "ln1",
                    attn: str = "attn"):
    """x + attention(norm(x)) on local shards; x in the residual layout.
    Attention runs on the local heads when the model axis divides both
    head counts (else on every head, the weights gathered); `attn_fn(q,
    k, v)` (default causal) returns its output on the local heads."""
    w = lay.layer_weights(lp, specs)
    h = lay.norm(x, lp, specs, ln, partial=lay.sp)
    h = lay.to(h, FULL, lay.res, grad_partial=lay.heads)
    p = {k: w(f"{attn}/{k}", keep=lay.heads) for k in ("wq", "wk", "wv",
                                                       "wo")}
    if cfg.qk_norm:
        for k in ("qnorm", "knorm"):
            p[k] = w(f"{attn}/{k}", partial=lay.heads)
    local = lay.local_cfg()
    q, k, v = L.qkv_project(local, p, h, positions)
    if attn_fn is None:
        o = L.attention(q, k, v, causal=True, impl=cfg.attn_impl)
    else:
        o = attn_fn(q, k, v)
    y = L.output_project(local, p, o)
    return x + lay.to(y, lay.res, FULL, partial=lay.heads)


def mlp_block(cfg: ModelConfig, lay: Layout, specs: dict, x, lp: dict,
              ln: str = "ln2"):
    """x + mlp(norm(x)) on the local d_ff; x in the residual layout."""
    w = lay.layer_weights(lp, specs)
    h = lay.norm(x, lp, specs, ln, partial=lay.sp)
    h = lay.to(h, FULL, lay.res, grad_partial=lay.ff)
    mlp = {k: w(f"mlp/{k}", keep=lay.ff) for k in L.mlp_specs(cfg)}
    y = L.mlp(h, mlp, cfg.mlp_variant, DTYPES[cfg.dtype])
    return x + lay.to(y, lay.res, FULL, partial=lay.ff)


def stack_pspecs(pspecs: dict, key: str) -> dict:
    """{path: PartitionSpec} of one layer of the stacked group `key`."""
    return {p: s[1:] for p, s in flatten(pspecs[key])}


# ---------------------------------------------------------------------------
# Embedding, loss and logits
# ---------------------------------------------------------------------------

def embed(cfg: ModelConfig, lay: Layout, table, tokens):
    """The embedding lookup in the residual layout; with a vocabulary
    split over the model axis, each process looks up its rows and the
    rows are summed (Megatron's vocabulary-parallel embedding)."""
    dtype = DTYPES[cfg.dtype]
    tok = tokens.long()
    if not lay.vocab:
        x = table[tok].to(dtype)
        return lay.to(x, lay.res, FULL)
    n = table.shape[0]
    idx = tok - lay.mesh.index(lay.vocab[0]) * n
    mine = (idx >= 0) & (idx < n)
    x = torch.where(mine[..., None], table[idx.clamp(0, n - 1)],
                    0.0).to(dtype)
    return lay.to(x, lay.res, FULL, partial=lay.vocab)


def embed_table(lay: Layout, params: dict, pspecs: dict):
    """The embedding table as the lookup and the logits use it: gathered
    over the data axis, split over the vocabulary axis."""
    return lay.weight(params["embed"], pspecs["embed"], keep=lay.vocab)


def _head(lay: Layout, params: dict, pspecs: dict, table) -> dict:
    head = {"embed": table}
    if "unembed" in params:
        head["unembed"] = lay.weight(params["unembed"], pspecs["unembed"],
                                     keep=lay.vocab)
    return head


def _unembed(cfg: ModelConfig, head: dict, x):
    dtype = DTYPES[cfg.dtype]
    if cfg.tie_embeddings:
        return x.to(dtype) @ head["embed"].to(dtype).T
    return x.to(dtype) @ head["unembed"].to(dtype)


def _ce_block(cfg: ModelConfig, lay: Layout, head: dict, xs, ls):
    """(sum of the block's token NLLs over valid labels, their count),
    with the logits split over the vocabulary axis: the log-sum-exp and
    the label's logit summed over it."""
    logits = _unembed(cfg, head, xs).float()
    valid = (ls >= 0).float()
    if not lay.vocab:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          torch.clamp(ls, min=0).long()[..., None])[..., 0]
        return ((lse - ll) * valid).sum(), valid.sum()
    m, axes = lay.mesh, lay.vocab
    n = logits.shape[-1]
    mx = logits.detach().amax(-1)
    for a in axes:
        mx = all_reduce(mx, m, a, torch.distributed.ReduceOp.MAX)
    total = redistribute(torch.exp(logits - mx[..., None]).sum(-1), (), (),
                         m, partial=axes)
    lse = mx + torch.log(total)
    idx = ls.long() - m.index(axes[0]) * n
    mine = (idx >= 0) & (idx < n)
    ll = torch.gather(logits, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    ll = redistribute(torch.where(mine, ll, 0.0), (), (), m, partial=axes)
    return ((lse - ll) * valid).sum(), valid.sum()


def loss_head(cfg: ModelConfig, lay: Layout, params: dict, pspecs: dict,
              table, x, labels, norm: str = "final_norm"):
    """The final norm and the chunked cross-entropy of the residual
    stream `x` (blocks of 512 positions, the last padded with label -1,
    each recomputed in the backward): (this process's share of the mean
    loss, the global mean loss detached). The shares of the processes
    that hold distinct batch rows add up to the global mean."""
    mesh = lay.mesh
    w = functools.partial(lay.weight, partial=lay.sp)
    x = L.apply_norm(x, {k: w(t, pspecs[norm][k])
                         for k, t in params[norm].items()}, cfg.norm_eps)
    x = lay.to(x, FULL, lay.res, grad_partial=lay.vocab)
    head = _head(lay, params, pspecs, table)
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    S = x.shape[1]
    block = min(512, S)
    if S % block:
        pad = block - S % block
        x = torch.cat([x, x.new_zeros((x.shape[0], pad, x.shape[2]))], dim=1)
        labels = torch.cat([labels, labels.new_full((labels.shape[0], pad),
                                                    -1)], dim=1)
    for i in range(x.shape[1] // block):
        cols = slice(i * block, (i + 1) * block)
        blk_nll, blk_n = checkpoint(functools.partial(_ce_block, cfg, lay),
                                    head, x[:, cols], labels[:, cols],
                                    use_reentrant=False)
        nll, count = nll + blk_nll, count + blk_n
    for a in mesh.batch:
        count = all_reduce(count, mesh, a)
    share = nll / torch.clamp(count, min=1.0)
    ce = share.detach()
    for a in mesh.batch:
        ce = all_reduce(ce, mesh, a)
    return share, ce


def serve_setup(cfg: ModelConfig, spec_tree: dict, params: dict, tokens,
                S: int, mesh):
    """(layout, parameter PartitionSpecs, embedding table as used, the
    embedded tokens, global batch) for a serving step on local shards:
    the residual stream whole (the reference's prefill and decode
    constrain it to ("batch", "seq", None))."""
    B = tokens.shape[0] * math.prod(mesh.size(a) for a in mesh.batch)
    lay = Layout(cfg, mesh, B, S, res=FULL)
    pspecs = param_pspecs(spec_tree, mesh)
    table = embed_table(lay, params, pspecs)
    return lay, pspecs, table, embed(cfg, lay, table, tokens), B


def cache_chunk(spec, dim: int, mesh) -> tuple:
    """(PartitionSpec entry, start, size) of this process's chunk of
    dimension `dim` of a cache leaf (its `ParamSpec`) on `mesh`."""
    entry = logical_to_pspec(spec.axes, spec.shape, mesh)[dim]
    return (entry,) + shard_range(entry, spec.shape[dim], mesh)


def last_logits(cfg: ModelConfig, lay: Layout, params: dict, pspecs: dict,
                table, x, norm: str = "final_norm"):
    """The last position's logits (B_local, V_local): the final norm,
    then the unembedding on this process's vocabulary, laid out
    ("batch", "tp")."""
    x = L.apply_norm(x[:, -1:], {k: lay.weight(t, pspecs[norm][k])
                                 for k, t in params[norm].items()},
                     cfg.norm_eps)
    return _unembed(cfg, _head(lay, params, pspecs, table), x)[:, 0]


# ---------------------------------------------------------------------------
# Decode attention over a cache split along its slots
# ---------------------------------------------------------------------------

def split_decode_attention(q, ck, cv, mesh, axes, kv_pos=None, pos=None):
    """One query token against this process's cache slots, the others'
    on the mesh axes `axes` (flash-decoding). q (B, 1, Hq, Dh); ck, cv
    (B, Hkv, n, Dh). `attention_ref`'s softmax (float32, scale Dh^-1/2)
    with the maximum, then the rescaled sums and outputs, all-reduced
    over `axes`. `kv_pos` (n,): the absolute position each local slot
    holds, a slot past ``pos`` masked (causal); None: every slot valid
    (cross-attention)."""
    B, _, Hq, Dh = q.shape
    Hkv = ck.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, Dh).float() * Dh ** -0.5
    s = torch.einsum("bhgd,bhkd->bhgk", qg, ck.float())
    if kv_pos is not None:
        s = torch.where(kv_pos <= pos, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    for a in axes:
        m = all_reduce(m, mesh, a, torch.distributed.ReduceOp.MAX)
    p = torch.exp(s - m)
    part = torch.cat([torch.einsum("bhgk,bhkd->bhgd", p, cv.float()),
                      p.sum(-1, keepdim=True)], dim=-1)
    for a in axes:
        part = all_reduce(part, mesh, a)
    o = part[..., :Dh] / part[..., Dh:]
    return o.reshape(B, 1, Hq, Dh).to(q.dtype)
