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
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.cache import encdec_cache_specs
from repro_torch.models.params import DTYPES, ParamSpec, stack_specs


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


def _decoder_embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   offset: int = 0) -> torch.Tensor:
    B, S = tokens.shape
    dtype = DTYPES[cfg.dtype]
    x = T.embed_tokens(cfg, params, tokens)
    if offset == 0 and S > 1:
        pos = L.sinusoidal_positions(S, cfg.d_model, x.device).to(dtype)[None]
    else:
        # decode: the row of position `offset`, by the reference's own
        # expression (the offset times the frequencies)
        freqs = L.sinusoidal_frequencies(cfg.d_model, x.device)
        ang = torch.tensor(float(offset), dtype=torch.float32,
                           device=x.device) * freqs
        pos = torch.cat([torch.sin(ang), torch.cos(ang)])[None, None].to(dtype)
    return x + pos


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            remat: str = "none") -> tuple:
    """(loss, {"ce_loss"}): encode ``batch["frames"]``, run the decoder
    over ``batch["tokens"]`` (causal self-attention, cross-attention to
    the encoder's memory), each layer of both under the `remat` policy;
    the chunked cross-entropy against ``batch["labels"]``."""
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
            pad_to: int = 0) -> tuple:
    """Encode ``batch["frames"]`` and process the prompts
    ``batch["tokens"]``; return (last-position logits (B, V), cache).
    ``pad_to``: the self-attention cache's capacity (>= S)."""
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
                tokens: torch.Tensor) -> tuple:
    """One decode step. tokens (B,); returns (logits (B, V), cache) with
    the new key and value written at slot ``pos`` in place."""
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
