"""Decoder-only transformer, dense and MoE families: parameter specs,
the train forward and its chunked cross-entropy loss, prefill and decode
(the reference's `src/repro/models/transformer.py`).

The reference scans the layers (``lax.scan``) over parameters stacked on
a leading ``L`` axis; the port keeps the stacked layout and loops over
``L`` in Python. Numerics follow the reference exactly:

- with ``cast_weights`` the whole ``layers`` subtree, the ``ln1``/``ln2``
  norm scales included, runs in the activation dtype; ``final_norm``
  stays float32;
- the embedding is gathered and then cast; ``unembed`` casts the
  (tied) embedding to the activation dtype, so the logits are in that
  dtype (bfloat16 by default).

`prepare` does those casts once, for a server that calls prefill and
decode many times: a cast of a tensor already in the target dtype is
free, and casting before a gather equals casting after it, so prefill
and decode give the same numbers on prepared and on master parameters.

The decode step writes the new key and value into the cache in place
(the reference returns an updated copy); the returned cache holds the
same tensors.

Training (`loss_fn`) differentiates through float32 master parameters:
the casts to the activation dtype are inside the graph, as the
reference's ``cast_weights`` casts inside its loss. The forward unbinds
each stacked layer weight once (`torch.unbind`), so the backward writes
one stacked gradient, not a full-stack zero gradient per layer as
indexing ``t[i]`` would. `chunked_ce_loss` recomputes each 512-token
block's logits in the backward (`torch.utils.checkpoint`, as the
reference's ``jax.checkpoint``), so no (B, S, vocab) logits stay
resident.

On a mesh (`loss_fn`, `prefill` and `decode_step` with ``mesh=``) each
process holds its shard of every parameter (`Model.shardings`) and of
the batch, and runs the reference's GSPMD layouts by hand
(`repro_torch.models.sharding`; the blocks, the embedding, the loss and
the split decode attention that the other families share are in
`repro_torch.models.mesh_layers`), at the reference's `constrain`
points:

- weights are gathered over the data axis where they are used (FSDP;
  their gradients reduce-scattered back) and stay split over the model
  axis where the layer runs tensor-parallel: attention over the local
  heads when the model axis divides both head counts (else every head,
  the weights gathered), the MLP over the local d_ff, the logits and
  the cross-entropy over the local vocabulary (Megatron's vocabulary-
  parallel embedding and loss);
- with ``seq_shard`` the residual stream between layers is split over
  the model axis along the sequence, gathered before attention and the
  MLP and reduce-scattered after them;
- attention runs on the local batch rows and heads, through the same
  `L.attention` (the flash kernel on the card);
- the MoE block runs the reference's expert-parallel path
  (`moe.moe_apply` on a mesh) on the sequence gathered whole.

The loss a process returns is its share: the sum over the processes
that hold distinct batch rows is the global mean loss.

Serving on a mesh keeps the residual stream whole between layers (the
reference's prefill and decode constrain it to ("batch", "seq", None))
and the decode cache laid out by `cache.kv_cache_specs`: its sequence
split over the model axis ("kv_seq") where that axis divides it, every
head whole. The prefill gathers each layer's new keys and values over
the heads and writes this process's chunk of the sequence; a decode
step gathers the new token's query, key and value over the heads, the
process that owns slot ``pos`` writes it, and attention over the cache
is flash-decoding: each process takes the softmax statistics of its own
slots, and the maximum, then the rescaled sums and outputs are
all-reduced over the axis. The logits come out laid out as ("batch",
"tp"); the cache also carries its global slot count (``max_seq``),
which its local shape does not tell.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.config import MOE, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mesh_layers as ML
from repro_torch.models import moe as MOE_MOD
from repro_torch.models.cache import kv_cache_specs
from repro_torch.models.params import (DTYPES, ParamSpec, flatten,
                                      param_pspecs, stack_specs, tree_map)
from repro_torch.models.sharding import spec_axes


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def layer_specs(cfg: ModelConfig) -> dict:
    out = {
        "ln1": L.norm_specs(cfg.d_model, cfg.norm_kind),
        "attn": L.attention_specs(cfg),
        "ln2": L.norm_specs(cfg.d_model, cfg.norm_kind),
    }
    if cfg.family == MOE:
        out["moe"] = MOE_MOD.moe_specs(cfg)
    else:
        out["mlp"] = L.mlp_specs(cfg)
    return out


def specs(cfg: ModelConfig) -> dict:
    out = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("tp", "fsdp"),
                           init="normal"),
        "final_norm": L.norm_specs(cfg.d_model, cfg.norm_kind),
        "layers": stack_specs(cfg.n_layers, layer_specs(cfg)),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                   ("fsdp", "tp"), init="scaled")
    return out


def prepare(cfg: ModelConfig, params: dict, stacks=("layers",)) -> dict:
    """The parameters as prefill and decode use them, cast once: the
    embeddings and (with ``cast_weights``) the stacked layer groups
    `stacks` in the activation dtype, ``final_norm`` as it is."""
    dtype = DTYPES[cfg.dtype]
    out = dict(params)
    out["embed"] = params["embed"].to(dtype)
    if "unembed" in params:
        out["unembed"] = params["unembed"].to(dtype)
    if cfg.cast_weights:
        for key in stacks:
            if key in params:
                out[key] = L.cast_tree(params[key], dtype)
    return out


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(DTYPES[cfg.dtype])


def unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    dtype = DTYPES[cfg.dtype]
    if cfg.tie_embeddings:
        return x.to(dtype) @ params["embed"].to(dtype).T
    return x.to(dtype) @ params["unembed"].to(dtype)


def ffn(cfg: ModelConfig, lp: dict, h: torch.Tensor) -> tuple:
    """The layer's feed-forward block: (y, aux); aux holds the MoE's
    ``lb_loss`` and ``router_dropped`` and is empty for a dense MLP."""
    if cfg.family == MOE:
        return MOE_MOD.moe_apply(cfg, lp["moe"], h)
    return L.mlp(h, lp["mlp"], cfg.mlp_variant, DTYPES[cfg.dtype]), {}


def _layer_body(cfg: ModelConfig, x, lp, positions, attn_fn):
    """One layer: (x, aux) with the feed-forward block's aux."""
    h = L.apply_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_project(cfg, lp["attn"], h, positions)
    o = attn_fn(q, k, v)
    x = x + L.output_project(cfg, lp["attn"], o)
    h = L.apply_norm(x, lp["ln2"], cfg.norm_eps)
    y, aux = ffn(cfg, lp, h)
    return x + y, aux


def run_layers(cfg: ModelConfig, params: dict, key: str = "layers") -> dict:
    """The stacked layer group `key` as the layers run it: cast to the
    activation dtype with ``cast_weights`` (free once `prepare`d)."""
    if cfg.cast_weights:
        return L.cast_tree(params[key], DTYPES[cfg.dtype])
    return params[key]


def layer(layers: dict, i: int) -> dict:
    """Layer `i` of a stacked layer group."""
    return tree_map(lambda t: t[i], layers)


def maybe_remat(fn, remat: str):
    """`fn` with the reference's rematerialization policy: "none" saves
    every activation; "full" recomputes the layer in the backward
    (saving nothing inside it); "dots" saves the plain matmuls' outputs
    (2-D ``mm``; batched products are recomputed, as JAX's
    ``checkpoint_dots_with_no_batch_dims``) and recomputes the rest."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        saved = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         saved))
    raise ValueError(f"unknown remat policy {remat!r}")


def unbind_layers(layers: dict, n: int) -> list:
    """The per-layer dicts of a stacked layer group, each stack unbound
    once (one stacked gradient in the backward)."""
    flat = tree_map(lambda t: torch.unbind(t, 0), layers)
    return [tree_map(lambda ts, i=i: ts[i], flat) for i in range(n)]


# ---------------------------------------------------------------------------
# Train forward + chunked CE loss
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            remat: str = "none") -> tuple:
    """tokens (B,S) -> (final hidden states (B,S,D) pre-unembed, the MoE
    load-balancing loss summed over layers: 0 for a dense model)."""
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, lp):
        def attn_fn(q, k, v):
            return L.attention(q, k, v, causal=True, impl=cfg.attn_impl)
        x, aux = _layer_body(cfg, x, lp, positions, attn_fn)
        return x, aux.get("lb_loss", zero)

    step = maybe_remat(body, remat)
    lbs = []
    for lp in unbind_layers(run_layers(cfg, params), cfg.n_layers):
        x, lb = step(x, lp)
        lbs.append(lb)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.stack(lbs).sum()


def _ce_block(cfg: ModelConfig, params: dict, xs, ls):
    """(sum of the block's token NLLs over valid labels, their count)."""
    logits = unembed(cfg, params, xs).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(ls, min=0).long()[..., None])[..., 0]
    valid = (ls >= 0).float()
    return ((lse - ll) * valid).sum(), valid.sum()


def chunked_ce_loss(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    labels: torch.Tensor, block: int = 512) -> torch.Tensor:
    """Mean cross-entropy over labels >= 0 without materializing (B,S,V):
    blocks of `block` positions (the last padded with label -1), each
    recomputed in the backward."""
    B, S, D = x.shape
    block = min(block, S)
    if S % block:
        pad = block - S % block
        x = torch.cat([x, x.new_zeros((B, pad, D))], dim=1)
        labels = torch.cat([labels, labels.new_full((B, pad), -1)], dim=1)
        S = S + pad
    head = {k: params[k] for k in ("embed", "unembed") if k in params}
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // block):
        cols = slice(i * block, (i + 1) * block)
        blk_nll, blk_n = checkpoint(functools.partial(_ce_block, cfg), head,
                                    x[:, cols], labels[:, cols],
                                    use_reentrant=False)
        nll, n = nll + blk_nll, n + blk_n
    return nll / torch.clamp(n, min=1.0)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            remat: str = "none", mesh=None) -> tuple:
    """(total loss, {"ce_loss", "lb_loss"}): the chunked cross-entropy plus
    0.01 x the MoE load-balancing loss (0 for a dense model). On a mesh
    this process's share of the loss."""
    if mesh is not None:
        return _mesh_loss(cfg, params, batch, remat, mesh)
    x, lb_loss = forward(cfg, params, batch["tokens"], remat=remat)
    loss = chunked_ce_loss(cfg, params, x, batch["labels"])
    aux_coef = 0.01 if cfg.family == MOE else 0.0
    total = loss + aux_coef * lb_loss
    return total, {"ce_loss": loss, "lb_loss": lb_loss}


# ---------------------------------------------------------------------------
# Train forward + loss on a mesh
# ---------------------------------------------------------------------------

def _mesh_layer(cfg: ModelConfig, lay: ML.Layout, specs: dict, x, lp,
                positions, attn_fn=None):
    """One layer on local shards; x in the residual layout. `attn_fn(q,
    k, v)` (on the local heads; default causal attention) returns the
    attention's output on the local heads. Returns (x, the feed-forward
    block's aux)."""
    x = ML.attention_block(cfg, lay, specs, x, lp, positions, attn_fn)
    if cfg.family != MOE:
        return ML.mlp_block(cfg, lay, specs, x, lp), {}
    h = lay.norm(x, lp, specs, "ln2", partial=lay.sp)
    # the expert-parallel path's x gradient is a partial sum over the
    # model axis (each shard's experts); the fallback's is whole
    ep = MOE_MOD.expert_parallel(cfg, lay.mesh, lay.shape[0])
    h = lay.to(h, ML.FULL, lay.res, grad_partial=("model",) if ep else ())
    y, aux = MOE_MOD.moe_apply(
        cfg, {k: lp[f"moe/{k}"] for k in MOE_MOD.moe_specs(cfg)}, h,
        mesh=lay.mesh)
    return x + lay.to(y, lay.res, ML.FULL), aux


def _mesh_loss(cfg: ModelConfig, params: dict, batch: dict, remat: str,
               mesh) -> tuple:
    """`loss_fn` on local shards (`mesh.batch`: the axes that split the
    batch rows); returns this process's share of the loss and the global
    ce_loss and lb_loss as metrics."""
    tokens, labels = batch["tokens"], batch["labels"]
    nb = math.prod(mesh.size(a) for a in mesh.batch)
    B_local, S = tokens.shape
    lay = ML.Layout(cfg, mesh, B_local * nb, S)
    pspecs = param_pspecs(specs(cfg), mesh)
    lspecs = ML.stack_pspecs(pspecs, "layers")
    table = ML.embed_table(lay, params, pspecs)
    x = ML.embed(cfg, lay, table, tokens)
    positions = torch.arange(S, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, lp):
        x, aux = _mesh_layer(cfg, lay, lspecs, x, dict(flatten(lp)),
                             positions)
        return x, aux.get("lb_loss", zero)

    step = maybe_remat(body, remat)
    lbs = []
    for lp in unbind_layers(params["layers"], cfg.n_layers):
        x, lb = step(x, lp)
        lbs.append(lb)
    share, ce = ML.loss_head(cfg, lay, params, pspecs, table, x, labels)
    if cfg.family != MOE:
        return share, {"ce_loss": ce, "lb_loss": torch.zeros_like(ce)}
    # lb is the same on every process, an all-reduce whose backward hands
    # each process its own term: its value enters each batch shard's share
    # once over the shards, its gradient whole
    lb = torch.stack(lbs).sum()
    total = share + 0.01 * (lb.detach() / nb + (lb - lb.detach()))
    return total, {"ce_loss": ce, "lb_loss": lb.detach()}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params: dict, batch: dict,
            pad_to: int = 0, mesh=None) -> tuple:
    """Process full prompts; return (last-position logits (B,V), cache).

    ``pad_to``: total cache capacity (>= S) so that decode steps have
    slots to write. On a mesh (`sharding.Mesh.for_batch` of the global
    prompts), this process's shards in and out (`_mesh_prefill`).
    """
    if mesh is not None:
        return _mesh_prefill(cfg, params, batch, pad_to, mesh)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)
    cap = max(pad_to, S)
    kv_shape = (cfg.n_layers, B, cfg.n_kv_heads, cap, cfg.head_dim)
    ck = torch.zeros(kv_shape, dtype=x.dtype, device=x.device)
    cv = torch.zeros(kv_shape, dtype=x.dtype, device=x.device)
    layers = run_layers(cfg, params)
    for i in range(cfg.n_layers):
        def attn_fn(q, k, v, i=i):
            ck[i, :, :, :S] = k.transpose(1, 2)      # cache layout (B,Hkv,S,Dh)
            cv[i, :, :, :S] = v.transpose(1, 2)
            return L.attention(q, k, v, causal=True, impl=cfg.attn_impl)
        x, _ = _layer_body(cfg, x, layer(layers, i), positions, attn_fn)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(cfg, params, x[:, -1:, :])[:, 0]
    return logits, {"k": ck, "v": cv, "pos": S}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, mesh=None) -> tuple:
    """One decode step. tokens (B,); returns (logits (B,V), cache) with
    the new key and value written at slot ``pos`` in place. On a mesh,
    this process's shards in and out (`_mesh_decode`)."""
    if mesh is not None:
        return _mesh_decode(cfg, params, cache, tokens, mesh)
    pos = int(cache["pos"])
    ck, cv = cache["k"], cache["v"]
    if pos >= ck.shape[3]:
        raise IndexError(f"the cache is full ({ck.shape[3]} slots); prefill "
                         f"with a larger pad_to")
    x = embed_tokens(cfg, params, tokens[:, None])
    positions = torch.arange(pos, pos + 1, device=x.device)
    layers = run_layers(cfg, params)
    for i in range(cfg.n_layers):
        def attn_fn(q, k, v, i=i):
            ck[i, :, :, pos] = k[:, 0]
            cv[i, :, :, pos] = v[:, 0]
            return L.attention(q, ck[i].transpose(1, 2), cv[i].transpose(1, 2),
                               causal=True, q_offset=pos, kv_len=pos + 1)
        x, _ = _layer_body(cfg, x, layer(layers, i), positions, attn_fn)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(cfg, params, x)[:, 0]
    return logits, {"k": ck, "v": cv, "pos": pos + 1}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return kv_cache_specs(cfg, batch, max_seq)


# ---------------------------------------------------------------------------
# Prefill / decode on a mesh
# ---------------------------------------------------------------------------

def _serve_setup(cfg: ModelConfig, params: dict, tokens, S: int, mesh):
    """(layout, parameter PartitionSpecs, per-layer specs, embedding as
    used, the embedded tokens, global batch) for a serving step on local
    shards."""
    lay, pspecs, table, x, B = ML.serve_setup(cfg, specs(cfg), params,
                                              tokens, S, mesh)
    return lay, pspecs, ML.stack_pspecs(pspecs, "layers"), table, x, B


def _mesh_prefill(cfg: ModelConfig, params: dict, batch: dict, pad_to: int,
                  mesh) -> tuple:
    """`prefill` on local shards: this process's prompt rows in, its
    logits (rows, vocabulary) and cache shard out. Attention runs on the
    local rows and heads (the flash kernel on the card); each layer's
    keys and values are gathered over the heads and this process's
    chunk of the cache's sequence is written."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    lay, pspecs, lspecs, table, x, B = _serve_setup(cfg, params, tokens, S,
                                                    mesh)
    cap = max(pad_to, S)
    _, start, n = ML.cache_chunk(kv_cache_specs(cfg, B, cap)["k"], 3, mesh)
    lo, hi = min(start, S), min(start + n, S)       # prompt slots held here
    kv_shape = (cfg.n_layers, x.shape[0], cfg.n_kv_heads, n, cfg.head_dim)
    ck = torch.zeros(kv_shape, dtype=x.dtype, device=x.device)
    cv = torch.zeros(kv_shape, dtype=x.dtype, device=x.device)
    positions = torch.arange(S, device=x.device)
    for i in range(cfg.n_layers):
        def attn_fn(q, k, v, i=i):
            for c, t in ((ck, k), (cv, v)):
                c[i, :, :, lo - start:hi - start] = lay.whole_heads(
                    t)[:, lo:hi].transpose(1, 2)
            return L.attention(q, k, v, causal=True, impl=cfg.attn_impl)
        x, _ = _mesh_layer(cfg, lay, lspecs, x, dict(flatten(layer(
            params["layers"], i))), positions, attn_fn)
    logits = ML.last_logits(cfg, lay, params, pspecs, table, x)
    return logits, {"k": ck, "v": cv, "pos": S, "max_seq": cap}


def _mesh_decode(cfg: ModelConfig, params: dict, cache: dict, tokens,
                 mesh) -> tuple:
    """`decode_step` on local shards: this process's rows of the tokens
    in, its logits (rows, vocabulary) out, the cache shard written in
    place where it holds slot ``pos``."""
    pos, cap = int(cache["pos"]), int(cache["max_seq"])
    ck, cv = cache["k"], cache["v"]
    if pos >= cap:
        raise IndexError(f"the cache is full ({cap} slots); prefill with a "
                         f"larger pad_to")
    lay, pspecs, lspecs, table, x, B = _serve_setup(cfg, params,
                                                    tokens[:, None], 1, mesh)
    entry, start, n = ML.cache_chunk(kv_cache_specs(cfg, B, cap)["k"], 3,
                                     mesh)
    kv_pos = torch.arange(start, start + n, device=x.device)
    positions = torch.arange(pos, pos + 1, device=x.device)
    for i in range(cfg.n_layers):
        def attn_fn(q, k, v, i=i):
            q, k, v = (lay.whole_heads(t) for t in (q, k, v))
            if start <= pos < start + n:
                ck[i, :, :, pos - start] = k[:, 0]
                cv[i, :, :, pos - start] = v[:, 0]
            if n < cap:
                o = ML.split_decode_attention(q, ck[i], cv[i], mesh,
                                              spec_axes(entry), kv_pos, pos)
            else:
                o = L.attention(q, ck[i].transpose(1, 2),
                                cv[i].transpose(1, 2), causal=True,
                                q_offset=pos, kv_len=pos + 1)
            return lay.local_heads(o)
        x, _ = _mesh_layer(cfg, lay, lspecs, x, dict(flatten(layer(
            params["layers"], i))), positions, attn_fn)
    logits = ML.last_logits(cfg, lay, params, pspecs, table, x)
    return logits, {**cache, "pos": pos + 1}
