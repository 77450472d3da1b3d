"""Whisper-style encoder-decoder backbone (the reference's
`src/repro/models/encdec.py`): parameter specs, encoder, training loss,
prefill and decode.

The audio frontend is a stub, as in the reference: a prefill takes
precomputed frame embeddings ``batch["frames"]`` (B, enc_seq, d_model)
beside the decoder's ``batch["tokens"]``. Positions are sinusoidal on
both sides; projections have no biases.

Numerics follow the reference: with ``cast_weights`` the stacked
``enc_layers`` and ``dec_layers`` run in the activation dtype while
``enc_norm`` and ``final_norm`` stay float32; the frames are cast and
then added to the positions cast to the activation dtype; a decode step
builds its position row with the reference's own expression.

The prefill's attention calls (the encoder's non-causal self-attention
over the frames, the decoder's causal self-attention, the cross-attention
of the prompt rows against the encoder memory) take the flash kernel on
the card, and so do the training loss's (`loss_fn`, under grad through
`FlashAttentionFn`); a decode step's single-row calls take the plain
path. The decode step writes the new key and value into the
self-attention cache in place; the cross-attention cache is written
once, by the prefill.

On a mesh (``mesh=``; `repro_torch.models.mesh_layers`) the frames
split by rows only; the encoder's layers and the decoder's self- and
cross-attention run on the local heads and its MLPs on the local d_ff
where the model axis divides them (the layer norms' scales and biases
replicated); the memory's gradient is summed over the heads' axes. The
self-attention cache and the cross-attention cache both split their
slots over the model axis ("kv_seq"): a decode step's cross-attention
is the non-causal split attention over the encoder's positions.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mesh_layers as ML
from repro_torch.models import transformer as T
from repro_torch.models.cache import encdec_cache_specs
from repro_torch.models.params import (DTYPES, ParamSpec, flatten,
                                      param_pspecs, stack_specs)
from repro_torch.models.sharding import spec_axes


def enc_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.norm_specs(cfg.d_model, cfg.norm_kind),
        "attn": L.attention_specs(cfg),
        "ln2": L.norm_specs(cfg.d_model, cfg.norm_kind),
        "mlp": L.mlp_specs(cfg),
    }


def dec_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.norm_specs(cfg.d_model, cfg.norm_kind),
        "attn": L.attention_specs(cfg),
        "lnx": L.norm_specs(cfg.d_model, cfg.norm_kind),
        "xattn": L.attention_specs(cfg),
        "ln2": L.norm_specs(cfg.d_model, cfg.norm_kind),
        "mlp": L.mlp_specs(cfg),
    }


# the parameters a decode step does not read: the encoder (its memory is
# in the cross-attention cache) and the cross-attention's key and value
# projections (their outputs are that cache)
DECODE_UNREAD = ("enc_layers", "enc_norm", "dec_layers/xattn/wk",
                 "dec_layers/xattn/wv")


def specs(cfg: ModelConfig) -> dict:
    out = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("tp", "fsdp"),
                           init="normal"),
        "enc_layers": stack_specs(cfg.n_enc_layers, enc_layer_specs(cfg)),
        "enc_norm": L.norm_specs(cfg.d_model, cfg.norm_kind),
        "dec_layers": stack_specs(cfg.n_layers, dec_layer_specs(cfg)),
        "final_norm": L.norm_specs(cfg.d_model, cfg.norm_kind),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                   ("fsdp", "tp"), init="scaled")
    return out


def prepare(cfg: ModelConfig, params: dict) -> dict:
    """The parameters cast once for serving: the embeddings and (with
    ``cast_weights``) both layer stacks; the two final norms as they
    are."""
    return T.prepare(cfg, params, stacks=("enc_layers", "dec_layers"))


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
           remat: str = "none") -> torch.Tensor:
    """frames (B, enc_seq, D) -> memory (B, enc_seq, D); each layer under
    the `remat` policy (`transformer.maybe_remat`)."""
    dtype = DTYPES[cfg.dtype]
    S = frames.shape[1]
    pos = L.sinusoidal_positions(S, cfg.d_model, frames.device).to(dtype)
    x = frames.to(dtype) + pos[None]

    def body(x, lp):
        h = L.apply_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_project(cfg, lp["attn"], h, None)
        o = L.attention(q, k, v, causal=False, impl=cfg.attn_impl)
        x = x + L.output_project(cfg, lp["attn"], o)
        return x + L.mlp(L.apply_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"],
                         cfg.mlp_variant, dtype)

    step = T.maybe_remat(body, remat)
    for lp in T.unbind_layers(T.run_layers(cfg, params, "enc_layers"),
                              cfg.n_enc_layers):
        x = step(x, lp)
    return L.apply_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_attend(cfg: ModelConfig, bp: dict, x, memory=None,
                  cached_kv=None):
    """Cross-attention: q from x, keys and values from the encoder
    memory or from the cache ((B, Hkv, enc_seq, Dh) each). Returns
    (x + the attention's output, (k, v) as (B, enc_seq, Hkv, Dh))."""
    h = L.apply_norm(x, bp["lnx"], cfg.norm_eps)
    dtype = h.dtype
    B, Sq = h.shape[0], h.shape[1]
    p = bp["xattn"]
    q = (h @ p["wq"].to(dtype)).reshape(B, Sq, cfg.n_heads, cfg.head_dim)
    if cached_kv is not None:
        k, v = (t.transpose(1, 2) for t in cached_kv)
    else:
        Se = memory.shape[1]
        shape = (B, Se, cfg.n_kv_heads, cfg.head_dim)
        k = (memory @ p["wk"].to(dtype)).reshape(shape)
        v = (memory @ p["wv"].to(dtype)).reshape(shape)
    o = L.attention(q, k, v, causal=False, impl=cfg.attn_impl)
    return x + L.output_project(cfg, {"wo": p["wo"]}, o), (k, v)


def _positions(cfg: ModelConfig, S: int, offset: int, device):
    """The decoder's sinusoidal positions (1, S, d) in the activation
    dtype: of a prompt (``offset`` 0, S > 1), or of one decode step."""
    dtype = DTYPES[cfg.dtype]
    if offset == 0 and S > 1:
        return L.sinusoidal_positions(S, cfg.d_model, device).to(dtype)[None]
    # decode: the row of position `offset`, by the reference's own
    # expression (the offset times the frequencies)
    freqs = L.sinusoidal_frequencies(cfg.d_model, device)
    ang = torch.tensor(float(offset), dtype=torch.float32,
                       device=device) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None].to(dtype)


def _decoder_embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   offset: int = 0) -> torch.Tensor:
    x = T.embed_tokens(cfg, params, tokens)
    return x + _positions(cfg, tokens.shape[1], offset, x.device)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            remat: str = "none", mesh=None) -> tuple:
    """(loss, {"ce_loss"}): encode ``batch["frames"]``, run the decoder
    over ``batch["tokens"]`` (causal self-attention, cross-attention to
    the encoder's memory), each layer of both under the `remat` policy;
    the chunked cross-entropy against ``batch["labels"]``. On a mesh
    this process's share of the loss (`_mesh_loss`)."""
    if mesh is not None:
        return _mesh_loss(cfg, params, batch, remat, mesh)
    memory = encode(cfg, params, batch["frames"], remat=remat)
    tokens = batch["tokens"]
    x = _decoder_embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    dtype = DTYPES[cfg.dtype]

    def body(x, lp, memory):
        h = L.apply_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_project(cfg, lp["attn"], h, positions)
        o = L.attention(q, k, v, causal=True, impl=cfg.attn_impl)
        x = x + L.output_project(cfg, lp["attn"], o)
        x, _ = _cross_attend(cfg, lp, x, memory=memory)
        return x + L.mlp(L.apply_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"],
                         cfg.mlp_variant, dtype)

    step = T.maybe_remat(body, remat)
    for lp in T.unbind_layers(T.run_layers(cfg, params, "dec_layers"),
                              cfg.n_layers):
        x = step(x, lp, memory)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_eps)
    loss = T.chunked_ce_loss(cfg, params, x, batch["labels"])
    return loss, {"ce_loss": loss}


def prefill(cfg: ModelConfig, params: dict, batch: dict,
            pad_to: int = 0, mesh=None) -> tuple:
    """Encode ``batch["frames"]`` and process the prompts
    ``batch["tokens"]``; return (last-position logits (B, V), cache).
    ``pad_to``: the self-attention cache's capacity (>= S). On a mesh,
    this process's shards in and out (`_mesh_prefill`)."""
    if mesh is not None:
        return _mesh_prefill(cfg, params, batch, pad_to, mesh)
    memory = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _decoder_embed(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)
    Lyr, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    new = dict(dtype=x.dtype, device=x.device)
    ck = torch.zeros((Lyr, B, Hkv, max(pad_to, S), Dh), **new)
    cv = torch.zeros_like(ck)
    cxk = torch.empty((Lyr, B, Hkv, memory.shape[1], Dh), **new)
    cxv = torch.empty_like(cxk)
    dec = T.run_layers(cfg, params, "dec_layers")
    for i in range(Lyr):
        lp = T.layer(dec, i)
        h = L.apply_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_project(cfg, lp["attn"], h, positions)
        ck[i, :, :, :S] = k.transpose(1, 2)          # (B, Hkv, S, Dh)
        cv[i, :, :, :S] = v.transpose(1, 2)
        o = L.attention(q, k, v, causal=True, impl=cfg.attn_impl)
        x = x + L.output_project(cfg, lp["attn"], o)
        x, (xk, xv) = _cross_attend(cfg, lp, x, memory=memory)
        cxk[i] = xk.transpose(1, 2)
        cxv[i] = xv.transpose(1, 2)
        x = x + L.mlp(L.apply_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"],
                      cfg.mlp_variant, DTYPES[cfg.dtype])
    x = L.apply_norm(x, params["final_norm"], cfg.norm_eps)
    logits = T.unembed(cfg, params, x[:, -1:, :])[:, 0]
    return logits, {"k": ck, "v": cv, "ck": cxk, "cv": cxv, "pos": S}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, mesh=None) -> tuple:
    """One decode step. tokens (B,); returns (logits (B, V), cache) with
    the new key and value written at slot ``pos`` in place. On a mesh,
    this process's shards in and out (`_mesh_decode`)."""
    if mesh is not None:
        return _mesh_decode(cfg, params, cache, tokens, mesh)
    pos = int(cache["pos"])
    ck, cv = cache["k"], cache["v"]
    if pos >= ck.shape[3]:
        raise IndexError(f"the cache is full ({ck.shape[3]} slots); prefill "
                         f"with a larger pad_to")
    x = _decoder_embed(cfg, params, tokens[:, None], offset=pos)
    dec = T.run_layers(cfg, params, "dec_layers")
    for i in range(cfg.n_layers):
        lp = T.layer(dec, i)
        h = L.apply_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_project(cfg, lp["attn"], h, None)
        ck[i, :, :, pos] = k[:, 0]
        cv[i, :, :, pos] = v[:, 0]
        o = L.attention(q, ck[i].transpose(1, 2), cv[i].transpose(1, 2),
                        causal=True, q_offset=pos, kv_len=pos + 1)
        x = x + L.output_project(cfg, lp["attn"], o)
        x, _ = _cross_attend(cfg, lp, x,
                             cached_kv=(cache["ck"][i], cache["cv"][i]))
        x = x + L.mlp(L.apply_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"],
                      cfg.mlp_variant, DTYPES[cfg.dtype])
    x = L.apply_norm(x, params["final_norm"], cfg.norm_eps)
    logits = T.unembed(cfg, params, x)[:, 0]
    return logits, {"k": ck, "v": cv, "ck": cache["ck"], "cv": cache["cv"],
                    "pos": pos + 1}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return encdec_cache_specs(cfg, batch, max_seq)


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

def _non_causal(cfg: ModelConfig):
    return lambda q, k, v: L.attention(q, k, v, causal=False,
                                       impl=cfg.attn_impl)


def _mesh_encode(cfg: ModelConfig, params: dict, pspecs: dict, frames,
                 B: int, mesh, remat: str = "none") -> tuple:
    """`encode` on local shards: this process's rows of the frames (the
    sequence whole, ("batch", "seq", None)) -> (the encoder's layout,
    its memory). Each layer's attention runs on the local heads (the
    flash kernel on the card), its MLP on the local d_ff."""
    lay = ML.Layout(cfg, mesh, B, frames.shape[1], res=ML.FULL)
    especs = ML.stack_pspecs(pspecs, "enc_layers")
    pos = L.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                 frames.device).to(DTYPES[cfg.dtype])
    x = frames.to(DTYPES[cfg.dtype]) + pos[None]

    def body(x, lp):
        lp = dict(flatten(lp))
        x = ML.attention_block(cfg, lay, especs, x, lp, None,
                               _non_causal(cfg))
        return ML.mlp_block(cfg, lay, especs, x, lp)

    step = T.maybe_remat(body, remat)
    for lp in T.unbind_layers(params["enc_layers"], cfg.n_enc_layers):
        x = step(x, lp)
    norm = {k: lay.weight(t, pspecs["enc_norm"][k])
            for k, t in params["enc_norm"].items()}
    return lay, L.apply_norm(x, norm, cfg.norm_eps)


def _mesh_cross(cfg: ModelConfig, lay: ML.Layout, specs: dict, x, lp,
                memory=None, attn_fn=None) -> tuple:
    """`_cross_attend` on local shards, x in the residual layout: q from
    x on the local heads; keys and values from the encoder memory (whole
    over the model axis) on the local heads, or `attn_fn(q)` over the
    cache. Returns (x, (k, v) of the local heads or None)."""
    w = lay.layer_weights(lp, specs)
    h = lay.norm(x, lp, specs, "lnx", partial=lay.sp)
    h = lay.to(h, ML.FULL, lay.res, grad_partial=lay.heads)
    dtype = h.dtype
    B, Sq = h.shape[0], h.shape[1]
    q = (h @ w("xattn/wq", keep=lay.heads).to(dtype)).reshape(
        B, Sq, lay.n_heads, cfg.head_dim)
    kv = None
    if memory is not None:
        shape = (B, memory.shape[1], lay.n_kv_heads, cfg.head_dim)
        kv = tuple((memory @ w(f"xattn/{n}", keep=lay.heads).to(dtype))
                   .reshape(shape) for n in ("wk", "wv"))
        o = L.attention(q, *kv, causal=False, impl=cfg.attn_impl)
    else:
        o = attn_fn(q)
    y = L.output_project(lay.local_cfg(),
                         {"wo": w("xattn/wo", keep=lay.heads)}, o)
    return x + lay.to(y, lay.res, ML.FULL, partial=lay.heads), kv


def _mesh_loss(cfg: ModelConfig, params: dict, batch: dict, remat: str,
               mesh) -> tuple:
    """`loss_fn` on local shards: this process's share of the loss, the
    global ce_loss as the metric. The memory's gradient, a partial sum
    over the heads' axes (each process's cross-attention keys and values
    of its heads), is summed there."""
    tokens = batch["tokens"]
    B_local, S = tokens.shape
    B = B_local * math.prod(mesh.size(a) for a in mesh.batch)
    pspecs = param_pspecs(specs(cfg), mesh)
    lay = ML.Layout(cfg, mesh, B, S)
    elay, memory = _mesh_encode(cfg, params, pspecs, batch["frames"], B,
                                mesh, remat)
    memory = elay.to(memory, ML.FULL, ML.FULL, grad_partial=lay.heads)
    table = ML.embed_table(lay, params, pspecs)
    x = ML.embed(cfg, lay, table, tokens)
    x = x + lay.seq_chunk(_positions(cfg, S, 0, x.device)[0])[None]
    positions = torch.arange(S, device=x.device)
    dspecs = ML.stack_pspecs(pspecs, "dec_layers")

    def body(x, lp, memory):
        lp = dict(flatten(lp))
        x = ML.attention_block(cfg, lay, dspecs, x, lp, positions)
        x, _ = _mesh_cross(cfg, lay, dspecs, x, lp, memory=memory)
        return ML.mlp_block(cfg, lay, dspecs, x, lp)

    step = T.maybe_remat(body, remat)
    for lp in T.unbind_layers(params["dec_layers"], cfg.n_layers):
        x = step(x, lp, memory)
    share, ce = ML.loss_head(cfg, lay, params, pspecs, table, x,
                             batch["labels"])
    return share, {"ce_loss": ce}


def _cache_chunks(cfg: ModelConfig, mesh, B: int, cap: int) -> tuple:
    """`mesh_layers.cache_chunk` of the self-attention cache's ``cap``
    slots and of the cross-attention cache's ``enc_seq`` (both
    "kv_seq")."""
    specs = encdec_cache_specs(cfg, B, cap)
    return tuple(ML.cache_chunk(specs[n], 3, mesh) for n in ("k", "ck"))


def _mesh_prefill(cfg: ModelConfig, params: dict, batch: dict, pad_to: int,
                  mesh) -> tuple:
    """`prefill` on local shards: this process's rows of the frames and
    prompts in, its logits (rows, vocabulary) and cache shard out: of
    each layer's keys and values (gathered over the heads) the chunk of
    the self-attention cache's slots and of the encoder's positions it
    holds."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    lay, pspecs, table, x, B = ML.serve_setup(cfg, specs(cfg), params,
                                              tokens, S, mesh)
    x = x + _positions(cfg, S, 0, x.device)
    _, memory = _mesh_encode(cfg, params, pspecs, batch["frames"], B, mesh)
    cap = max(pad_to, S)
    (_, start, n), (_, e0, ne) = _cache_chunks(cfg, mesh, B, cap)
    lo, hi = min(start, S), min(start + n, S)       # prompt slots held here
    Lyr, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    new = dict(dtype=x.dtype, device=x.device)
    ck = torch.zeros((Lyr, x.shape[0], Hkv, n, Dh), **new)
    cv = torch.zeros_like(ck)
    cxk = torch.empty((Lyr, x.shape[0], Hkv, ne, Dh), **new)
    cxv = torch.empty_like(cxk)
    positions = torch.arange(S, device=x.device)
    dspecs = ML.stack_pspecs(pspecs, "dec_layers")
    for i in range(Lyr):
        lp = dict(flatten(T.layer(params["dec_layers"], i)))

        def attn_fn(q, k, v, i=i):
            for c, t in ((ck, k), (cv, v)):
                c[i, :, :, lo - start:hi - start] = lay.whole_heads(
                    t)[:, lo:hi].transpose(1, 2)
            return L.attention(q, k, v, causal=True, impl=cfg.attn_impl)
        x = ML.attention_block(cfg, lay, dspecs, x, lp, positions, attn_fn)
        x, (xk, xv) = _mesh_cross(cfg, lay, dspecs, x, lp, memory=memory)
        cxk[i] = lay.whole_heads(xk)[:, e0:e0 + ne].transpose(1, 2)
        cxv[i] = lay.whole_heads(xv)[:, e0:e0 + ne].transpose(1, 2)
        x = ML.mlp_block(cfg, lay, dspecs, x, lp)
    logits = ML.last_logits(cfg, lay, params, pspecs, table, x)
    return logits, {"k": ck, "v": cv, "ck": cxk, "cv": cxv, "pos": S,
                    "max_seq": cap}


def _mesh_decode(cfg: ModelConfig, params: dict, cache: dict, tokens,
                 mesh) -> tuple:
    """`decode_step` on local shards: this process's rows of the tokens
    in, its logits (rows, vocabulary) out. The process that holds slot
    ``pos`` writes the new key and value; the self-attention and the
    cross-attention run over the local slots, split over the model axis
    (flash-decoding; non-causal over the encoder's positions) where the
    slots are."""
    pos, cap = int(cache["pos"]), int(cache["max_seq"])
    ck, cv = cache["k"], cache["v"]
    if pos >= cap:
        raise IndexError(f"the cache is full ({cap} slots); prefill with a "
                         f"larger pad_to")
    lay, pspecs, table, x, B = ML.serve_setup(cfg, specs(cfg), params,
                                              tokens[:, None], 1, mesh)
    x = x + _positions(cfg, 1, pos, x.device)
    (entry, start, n), (xentry, _, ne) = _cache_chunks(cfg, mesh, B, cap)
    kv_pos = torch.arange(start, start + n, device=x.device)
    dspecs = ML.stack_pspecs(pspecs, "dec_layers")
    for i in range(cfg.n_layers):
        lp = dict(flatten(T.layer(params["dec_layers"], i)))

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

        def cross_fn(q, i=i):
            q = lay.whole_heads(q)
            cxk, cxv = cache["ck"][i], cache["cv"][i]
            if ne < cfg.enc_seq:
                o = ML.split_decode_attention(q, cxk, cxv, mesh,
                                              spec_axes(xentry))
            else:
                o = L.attention(q, cxk.transpose(1, 2), cxv.transpose(1, 2),
                                causal=False, impl=cfg.attn_impl)
            return lay.local_heads(o)
        x = ML.attention_block(cfg, lay, dspecs, x, lp, None, attn_fn)
        x, _ = _mesh_cross(cfg, lay, dspecs, x, lp, attn_fn=cross_fn)
        x = ML.mlp_block(cfg, lay, dspecs, x, lp)
    logits = ML.last_logits(cfg, lay, params, pspecs, table, x)
    return logits, {**cache, "pos": pos + 1}
