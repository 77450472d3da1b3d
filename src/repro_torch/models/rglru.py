"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
attention (the reference's `src/repro/models/rglru.py`).

The layer pattern (rec, rec, attn) runs as ``super`` superlayers (12 for
the 9B), then ``trail`` recurrent blocks (2 for the 9B: 38 = 12·3 + 2).
Every temporal-mixing block is followed by its own GeGLU MLP residual
block. On the card the recurrence runs the RG-LRU kernel (`ops.rglru`)
and the attention the flash kernel with the local window, in a prefill
and, under grad, inside their autograd Functions (`loss_fn`: the blocks
under the remat policy, the chunked cross-entropy).

Decode state is O(1) in the sequence: per recurrent block the RG-LRU
state and the conv history, per attention block a ring KV cache of
``local_window`` slots (slot p % W holds position p). The decode step
writes them in place (the reference returns updated copies). Numerics
as in the dense module: with ``cast_weights`` the stacked groups run in
the activation dtype, ``lam`` included (the gate takes
``softplus(lam.float())`` of that value); ``final_norm`` stays float32.

On a mesh (``mesh=``; `repro_torch.models.mesh_layers`) the recurrence
width splits over the model axis: ``wx``, ``wy`` and the conv on the
local channels, ``wr`` and ``wi`` on the conv output all-gathered, the
RG-LRU scan on the local channels, ``wo`` row-parallel. The multi-query
attention keeps every head (its one key head does not split) and runs
on the local rows; its ring cache splits its ``local_window`` slots
over the model axis ("kv_seq"): the prefill writes the slots it holds,
a decode step's new key goes to the process that holds slot ``pos %
W``, and attention runs over the local slots with the positions they
hold, the softmax statistics all-reduced.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mesh_layers as ML
from repro_torch.models import transformer as T
from repro_torch.models.cache import hybrid_cache_specs
from repro_torch.models.params import (ParamSpec, flatten, param_pspecs,
                                      stack_specs)
from repro_torch.models.sharding import redistribute, spec_axes

STACKS = ("super", "trail")


def _counts(cfg: ModelConfig) -> tuple:
    n_super = cfg.n_layers // len(cfg.block_pattern)
    return n_super, cfg.n_layers - n_super * len(cfg.block_pattern)


def rec_block_specs(cfg: ModelConfig) -> dict:
    d, lw, w = cfg.d_model, cfg.lru_width, cfg.conv_width
    return {
        "ln1": L.norm_specs(d),
        "wx": ParamSpec((d, lw), ("fsdp", "tp"), init="scaled"),
        "wy": ParamSpec((d, lw), ("fsdp", "tp"), init="scaled"),
        "conv_w": ParamSpec((w, lw), (None, "tp"), init="normal", scale=0.1),
        "conv_b": ParamSpec((lw,), ("tp",), init="zeros"),
        "wr": ParamSpec((lw, lw), ("fsdp", "tp"), init="scaled"),
        "br": ParamSpec((lw,), ("tp",), init="zeros"),
        "wi": ParamSpec((lw, lw), ("fsdp", "tp"), init="scaled"),
        "bi": ParamSpec((lw,), ("tp",), init="zeros"),
        "lam": ParamSpec((lw,), ("tp",), init="lru_lambda"),
        "wo": ParamSpec((lw, d), ("tp", "fsdp"), init="scaled"),
        "ln2": L.norm_specs(d),
        "mlp": L.mlp_specs(cfg),
    }


def attn_block_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.norm_specs(cfg.d_model),
        "attn": L.attention_specs(cfg),
        "ln2": L.norm_specs(cfg.d_model),
        "mlp": L.mlp_specs(cfg),
    }


def specs(cfg: ModelConfig) -> dict:
    n_super, n_trail = _counts(cfg)
    out = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("tp", "fsdp"),
                           init="normal"),
        "final_norm": L.norm_specs(cfg.d_model),
        "super": stack_specs(n_super, {"rec1": rec_block_specs(cfg),
                                       "rec2": rec_block_specs(cfg),
                                       "attn": attn_block_specs(cfg)}),
    }
    if n_trail:
        out["trail"] = stack_specs(n_trail, rec_block_specs(cfg))
    if not cfg.tie_embeddings:
        out["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                   ("fsdp", "tp"), init="scaled")
    return out


def prepare(cfg: ModelConfig, params: dict) -> dict:
    return T.prepare(cfg, params, stacks=STACKS)


def _mlp_residual(cfg: ModelConfig, bp: dict, x: torch.Tensor):
    return x + L.mlp(L.apply_norm(x, bp["ln2"], cfg.norm_eps), bp["mlp"],
                     cfg.mlp_variant, x.dtype)


# ---------------------------------------------------------------------------
# Blocks (sequence mode)
# ---------------------------------------------------------------------------

def rec_block_seq(cfg: ModelConfig, bp: dict, x: torch.Tensor, state=None):
    dtype = x.dtype
    h = L.apply_norm(x, bp["ln1"], cfg.norm_eps)
    u = h @ bp["wx"].to(dtype)
    gate = L.gelu((h @ bp["wy"].to(dtype)).float()).to(dtype)
    conv_in = state["conv"] if state else None
    h_in = state["h"] if state else None
    uc, conv_state = ops.causal_conv1d(u, bp["conv_w"], bp["conv_b"], conv_in)
    r = uc @ bp["wr"].to(dtype) + bp["br"].to(dtype)
    i = uc @ bp["wi"].to(dtype) + bp["bi"].to(dtype)
    hs, h_last = ops.rglru(uc, r, i, bp["lam"], h0=h_in)
    x = x + (hs * gate) @ bp["wo"].to(dtype)
    return _mlp_residual(cfg, bp, x), {"h": h_last, "conv": conv_state}


def attn_block_seq(cfg: ModelConfig, bp: dict, x: torch.Tensor, positions,
                   want_cache: bool = False):
    h = L.apply_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_project(cfg, bp["attn"], h, positions)
    o = L.attention(q, k, v, causal=True, window=cfg.local_window,
                    impl=cfg.attn_impl)
    x = x + L.output_project(cfg, bp["attn"], o)
    x = _mlp_residual(cfg, bp, x)
    if not want_cache:
        return x, None
    # ring cache: slot(p) = p % W holds the last W positions
    B, S, W = x.shape[0], k.shape[1], cfg.local_window
    start = max(0, S - W)
    slots = torch.arange(start, S, device=x.device) % W
    shape = (B, cfg.n_kv_heads, W, cfg.head_dim)
    ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
    cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
    ck[:, :, slots] = k.transpose(1, 2)[:, :, start:S]
    cv[:, :, slots] = v.transpose(1, 2)[:, :, start:S]
    return x, (ck, cv)


# ---------------------------------------------------------------------------
# Blocks (single-token decode mode)
# ---------------------------------------------------------------------------

def rec_block_step(cfg: ModelConfig, bp: dict, x: torch.Tensor, state: dict):
    """x (B,D); `state` {"h", "conv"} is updated in place."""
    dtype = x.dtype
    h = L.apply_norm(x, bp["ln1"], cfg.norm_eps)
    u = h @ bp["wx"].to(dtype)
    gate = L.gelu((h @ bp["wy"].to(dtype)).float()).to(dtype)
    uc, conv_state = ops.conv1d_decode_step(u, bp["conv_w"], bp["conv_b"],
                                            state["conv"])
    r = uc @ bp["wr"].to(dtype) + bp["br"].to(dtype)
    i = uc @ bp["wi"].to(dtype) + bp["bi"].to(dtype)
    hs, h_new = ops.rglru_decode_step(uc, r, i, bp["lam"], state["h"])
    state["conv"].copy_(conv_state)
    state["h"].copy_(h_new)
    x = x + (hs * gate) @ bp["wo"].to(dtype)
    return _mlp_residual(cfg, bp, x)


def attn_block_step(cfg: ModelConfig, bp: dict, x: torch.Tensor, ck, cv,
                    pos: int):
    """x (B,D); position `pos` is written into ring slot pos % W of the
    caches ck, cv (B,Hkv,W,Dh) in place."""
    W = cfg.local_window
    h = L.apply_norm(x[:, None, :], bp["ln1"], cfg.norm_eps)
    positions = torch.tensor([pos], device=x.device)
    q, k, v = L.qkv_project(cfg, bp["attn"], h, positions)
    ck[:, :, pos % W] = k[:, 0].to(ck.dtype)
    cv[:, :, pos % W] = v[:, 0].to(cv.dtype)
    # absolute position held by each ring slot (unwritten slots -> future)
    s = torch.arange(W, device=x.device)
    kv_pos = pos - torch.remainder(pos - s, W)
    kv_pos = torch.where(kv_pos >= 0, kv_pos, pos + 1)
    o = L.attention(q, ck.transpose(1, 2), cv.transpose(1, 2), causal=True,
                    q_offset=pos, kv_positions=kv_pos)
    x = x + L.output_project(cfg, bp["attn"], o)[:, 0]
    return _mlp_residual(cfg, bp, x)


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------

def _stack_states(states: list) -> dict:
    return {key: torch.stack([s[key] for s in states]) for key in ("h", "conv")}


def prefill(cfg: ModelConfig, params: dict, batch: dict,
            pad_to: int = 0, mesh=None) -> tuple:
    """Process full prompts; return (last-position logits (B,V), cache).
    The state is O(1) in the sequence: ``pad_to`` is unused. On a mesh,
    this process's shards in and out (`_mesh_prefill`)."""
    del pad_to
    if mesh is not None:
        return _mesh_prefill(cfg, params, batch, mesh)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = T.embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)
    n_super, n_trail = _counts(cfg)
    sup = T.run_layers(cfg, params, "super")
    s1, s2, ks, vs = [], [], [], []
    for j in range(n_super):
        lp = T.layer(sup, j)
        x, st = rec_block_seq(cfg, lp["rec1"], x)
        s1.append(st)
        x, st = rec_block_seq(cfg, lp["rec2"], x)
        s2.append(st)
        x, (ck, cv) = attn_block_seq(cfg, lp["attn"], x, positions,
                                     want_cache=True)
        ks.append(ck)
        vs.append(cv)
    cache = {"super": {"rec1": _stack_states(s1), "rec2": _stack_states(s2),
                       "k": torch.stack(ks), "v": torch.stack(vs)},
             "pos": S}
    if n_trail:
        tr = T.run_layers(cfg, params, "trail")
        st = []
        for j in range(n_trail):
            x, s = rec_block_seq(cfg, T.layer(tr, j), x)
            st.append(s)
        cache["trail"] = _stack_states(st)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_eps)
    logits = T.unembed(cfg, params, x[:, -1:, :])[:, 0]
    return logits, cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, mesh=None) -> tuple:
    """One decode step. tokens (B,); returns (logits (B,V), cache) with
    the states and the ring caches updated in place. On a mesh, this
    process's shards in and out (`_mesh_decode`)."""
    if mesh is not None:
        return _mesh_decode(cfg, params, cache, tokens, mesh)
    pos = int(cache["pos"])
    x = T.embed_tokens(cfg, params, tokens[:, None])[:, 0]
    n_super, n_trail = _counts(cfg)
    sc = cache["super"]
    sup = T.run_layers(cfg, params, "super")
    for j in range(n_super):
        lp = T.layer(sup, j)
        x = rec_block_step(cfg, lp["rec1"], x, T.layer(sc["rec1"], j))
        x = rec_block_step(cfg, lp["rec2"], x, T.layer(sc["rec2"], j))
        x = attn_block_step(cfg, lp["attn"], x, sc["k"][j], sc["v"][j], pos)
    if n_trail:
        tr = T.run_layers(cfg, params, "trail")
        for j in range(n_trail):
            x = rec_block_step(cfg, T.layer(tr, j), x,
                               T.layer(cache["trail"], j))
    x = L.apply_norm(x, params["final_norm"], cfg.norm_eps)
    logits = T.unembed(cfg, params, x[:, None, :])[:, 0]
    return logits, {**cache, "pos": pos + 1}


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            remat: str = "none") -> tuple:
    """tokens (B,S) -> (final hidden states (B,S,D) pre-unembed, 0): the
    superlayers, then the trailing recurrent blocks, each under the
    `remat` policy (`transformer.maybe_remat`)."""
    S = tokens.shape[1]
    x = T.embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)
    n_super, n_trail = _counts(cfg)

    def super_body(x, lp):
        x, _ = rec_block_seq(cfg, lp["rec1"], x)
        x, _ = rec_block_seq(cfg, lp["rec2"], x)
        return attn_block_seq(cfg, lp["attn"], x, positions)[0]

    def trail_body(x, lp):
        return rec_block_seq(cfg, lp, x)[0]

    for key, n, body in (("super", n_super, super_body),
                         ("trail", n_trail, trail_body)):
        if not n:
            continue
        step = T.maybe_remat(body, remat)
        for lp in T.unbind_layers(T.run_layers(cfg, params, key), n):
            x = step(x, lp)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            remat: str = "none", mesh=None) -> tuple:
    """(loss, {"ce_loss"}): the chunked cross-entropy of `forward`. On a
    mesh this process's share of the loss (`_mesh_loss`)."""
    if mesh is not None:
        return _mesh_loss(cfg, params, batch, remat, mesh)
    x, _ = forward(cfg, params, batch["tokens"], remat=remat)
    loss = T.chunked_ce_loss(cfg, params, x, batch["labels"])
    return loss, {"ce_loss": loss}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    del max_seq  # O(1)-in-sequence state (window-bounded KV)
    return hybrid_cache_specs(cfg, batch)


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

def _block(flat: dict, key: str) -> dict:
    """The entries of block `key` of a superlayer's flat dict."""
    return {p[len(key) + 1:]: v for p, v in flat.items()
            if p.startswith(key + "/")}


def _mesh_rec_block(cfg: ModelConfig, lay: ML.Layout, specs: dict, x, lp):
    """`rec_block_seq` on local shards, x in the residual layout -> (x,
    the state {"h", "conv"} of the local channels). The recurrence width
    is split over the model axis (``lam``'s "tp"): ``wx`` and ``wy`` are
    column-parallel, the conv runs on the local channels; ``wr`` and
    ``wi`` take the conv output whole (all-gathered) into the local
    channels' gates; the RG-LRU scan (the kernel on the card) runs on the
    local channels; ``wo`` is row-parallel."""
    chan = spec_axes(specs["lam"][0])
    w = lay.layer_weights(lp, specs)
    h = lay.norm(x, lp, specs, "ln1", partial=lay.sp)
    h = lay.to(h, ML.FULL, lay.res, grad_partial=chan)
    dtype = h.dtype
    u = h @ w("wx", keep=chan).to(dtype)
    gate = L.gelu((h @ w("wy", keep=chan).to(dtype)).float()).to(dtype)
    uc, conv_state = ops.causal_conv1d(u, w("conv_w", keep=chan),
                                       w("conv_b", keep=chan))
    whole = redistribute(uc, (None, None, chan or None), (None,) * 3,
                         lay.mesh, grad_partial=chan)
    r = whole @ w("wr", keep=chan).to(dtype) + w("br", keep=chan).to(dtype)
    i = whole @ w("wi", keep=chan).to(dtype) + w("bi", keep=chan).to(dtype)
    hs, h_last = ops.rglru(uc, r, i, w("lam", keep=chan))
    y = (hs * gate) @ w("wo", keep=chan).to(dtype)
    x = x + lay.to(y, lay.res, ML.FULL, partial=chan)
    return (ML.mlp_block(cfg, lay, specs, x, lp),
            {"h": h_last, "conv": conv_state})


def _window_attention(cfg: ModelConfig):
    return lambda q, k, v: L.attention(q, k, v, causal=True,
                                       window=cfg.local_window,
                                       impl=cfg.attn_impl)


def _mesh_attn_block(cfg: ModelConfig, lay: ML.Layout, specs: dict, x, lp,
                     positions, attn_fn):
    """`attn_block_seq` (or its step) on local shards: the local
    attention (every head for a multi-query model, whose heads the model
    axis cannot split), then the MLP block."""
    x = ML.attention_block(cfg, lay, specs, x, lp, positions, attn_fn)
    return ML.mlp_block(cfg, lay, specs, x, lp)


def _mesh_loss(cfg: ModelConfig, params: dict, batch: dict, remat: str,
               mesh) -> tuple:
    """`loss_fn` on local shards: this process's share of the loss, the
    global ce_loss as the metric."""
    tokens = batch["tokens"]
    B_local, S = tokens.shape
    lay = ML.Layout(cfg, mesh, B_local * math.prod(
        mesh.size(a) for a in mesh.batch), S)
    pspecs = param_pspecs(specs(cfg), mesh)
    table = ML.embed_table(lay, params, pspecs)
    x = ML.embed(cfg, lay, table, tokens)
    positions = torch.arange(S, device=x.device)
    n_super, n_trail = _counts(cfg)
    sspecs = ML.stack_pspecs(pspecs, "super")
    tspecs = ML.stack_pspecs(pspecs, "trail") if n_trail else {}

    def super_body(x, lp):
        lp = dict(flatten(lp))
        for key in ("rec1", "rec2"):
            x, _ = _mesh_rec_block(cfg, lay, _block(sspecs, key), x,
                                   _block(lp, key))
        return _mesh_attn_block(cfg, lay, _block(sspecs, "attn"), x,
                                _block(lp, "attn"), positions,
                                _window_attention(cfg))

    def trail_body(x, lp):
        return _mesh_rec_block(cfg, lay, tspecs, x, dict(flatten(lp)))[0]

    for key, n, body in (("super", n_super, super_body),
                         ("trail", n_trail, trail_body)):
        if not n:
            continue
        step = T.maybe_remat(body, remat)
        for lp in T.unbind_layers(params[key], n):
            x = step(x, lp)
    share, ce = ML.loss_head(cfg, lay, params, pspecs, table, x,
                             batch["labels"])
    return share, {"ce_loss": ce}


def _mesh_prefill(cfg: ModelConfig, params: dict, batch: dict,
                  mesh) -> tuple:
    """`prefill` on local shards: this process's prompt rows in, its
    logits (rows, vocabulary) out, and its shard of the cache: the local
    channels' recurrent states, and of each ring cache the slots it
    holds, slot ``p % W`` of the last W positions p."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    lay, pspecs, table, x, B = ML.serve_setup(cfg, specs(cfg), params,
                                              tokens, S, mesh)
    positions = torch.arange(S, device=x.device)
    n_super, n_trail = _counts(cfg)
    sspecs = ML.stack_pspecs(pspecs, "super")
    # the ring caches' slots this process holds ("kv_seq")
    _, start, n = ML.cache_chunk(hybrid_cache_specs(cfg, B)["super"]["k"], 3,
                                 mesh)
    W = cfg.local_window
    held = S - 1 - torch.remainder(S - 1 - torch.arange(
        start, start + n, device=x.device), W)     # the position of each slot
    ok = held >= 0
    s1, s2, ks, vs = [], [], [], []
    window = _window_attention(cfg)
    for j in range(n_super):
        lp = dict(flatten(T.layer(params["super"], j)))
        x, st = _mesh_rec_block(cfg, lay, _block(sspecs, "rec1"), x,
                                _block(lp, "rec1"))
        s1.append(st)
        x, st = _mesh_rec_block(cfg, lay, _block(sspecs, "rec2"), x,
                                _block(lp, "rec2"))
        s2.append(st)
        shape = (x.shape[0], cfg.n_kv_heads, n, cfg.head_dim)
        ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
        cv = torch.zeros(shape, dtype=x.dtype, device=x.device)

        def attn_fn(q, k, v, ck=ck, cv=cv):
            for c, t in ((ck, k), (cv, v)):
                c[:, :, ok] = lay.whole_heads(t).transpose(1, 2)[
                    :, :, held[ok]]
            return window(q, k, v)
        x = _mesh_attn_block(cfg, lay, _block(sspecs, "attn"), x,
                             _block(lp, "attn"), positions, attn_fn)
        ks.append(ck)
        vs.append(cv)
    cache = {"super": {"rec1": _stack_states(s1),
                       "rec2": _stack_states(s2),
                       "k": torch.stack(ks), "v": torch.stack(vs)},
             "pos": S}
    if n_trail:
        tspecs = ML.stack_pspecs(pspecs, "trail")
        st = []
        for j in range(n_trail):
            x, s = _mesh_rec_block(cfg, lay, tspecs, x, dict(flatten(
                T.layer(params["trail"], j))))
            st.append(s)
        cache["trail"] = _stack_states(st)
    logits = ML.last_logits(cfg, lay, params, pspecs, table, x)
    return logits, cache


def _mesh_rec_step(cfg: ModelConfig, lay: ML.Layout, specs: dict, x, lp,
                   state: dict):
    """`rec_block_step` on local shards: x (B_local, 1, D); the local
    channels' state {"h", "conv"} updated in place; the conv output
    all-gathered whole for the gates."""
    chan = spec_axes(specs["lam"][0])
    w = lay.layer_weights(lp, specs)
    h = lay.norm(x, lp, specs, "ln1")[:, 0]
    dtype = h.dtype
    u = h @ w("wx", keep=chan).to(dtype)
    gate = L.gelu((h @ w("wy", keep=chan).to(dtype)).float()).to(dtype)
    uc, conv_state = ops.conv1d_decode_step(u, w("conv_w", keep=chan),
                                            w("conv_b", keep=chan),
                                            state["conv"])
    whole = redistribute(uc, (None, chan or None), (None, None), lay.mesh)
    r = whole @ w("wr", keep=chan).to(dtype) + w("br", keep=chan).to(dtype)
    i = whole @ w("wi", keep=chan).to(dtype) + w("bi", keep=chan).to(dtype)
    hs, h_new = ops.rglru_decode_step(uc, r, i, w("lam", keep=chan),
                                      state["h"])
    state["conv"].copy_(conv_state)
    state["h"].copy_(h_new)
    y = (hs * gate) @ w("wo", keep=chan).to(dtype)
    x = x + lay.to(y[:, None], ML.FULL, ML.FULL, partial=chan)
    return ML.mlp_block(cfg, lay, specs, x, lp)


def _mesh_decode(cfg: ModelConfig, params: dict, cache: dict, tokens,
                 mesh) -> tuple:
    """`decode_step` on local shards: this process's rows of the tokens
    in, its logits (rows, vocabulary) out, its cache shard updated in
    place. The process that holds ring slot ``pos % W`` writes the new
    key and value; attention over the ring runs on the local slots with
    the absolute positions they hold, split over the model axis (flash-
    decoding) where the slots are."""
    pos = int(cache["pos"])
    lay, pspecs, table, x, B = ML.serve_setup(cfg, specs(cfg), params,
                                              tokens[:, None], 1, mesh)
    n_super, n_trail = _counts(cfg)
    sspecs = ML.stack_pspecs(pspecs, "super")
    entry, start, n = ML.cache_chunk(hybrid_cache_specs(cfg, B)["super"]["k"],
                                     3, mesh)
    W = cfg.local_window
    slots = torch.arange(start, start + n, device=x.device)
    kv_pos = pos - torch.remainder(pos - slots, W)
    kv_pos = torch.where(kv_pos >= 0, kv_pos, pos + 1)
    positions = torch.tensor([pos], device=x.device)
    sc = cache["super"]
    for j in range(n_super):
        lp = dict(flatten(T.layer(params["super"], j)))
        for key in ("rec1", "rec2"):
            x = _mesh_rec_step(cfg, lay, _block(sspecs, key), x,
                               _block(lp, key), T.layer(sc[key], j))

        def attn_fn(q, k, v, ck=sc["k"][j], cv=sc["v"][j]):
            q, k, v = (lay.whole_heads(t) for t in (q, k, v))
            if start <= pos % W < start + n:
                ck[:, :, pos % W - start] = k[:, 0].to(ck.dtype)
                cv[:, :, pos % W - start] = v[:, 0].to(cv.dtype)
            if n < W:
                o = ML.split_decode_attention(q, ck, cv, mesh,
                                              spec_axes(entry), kv_pos, pos)
            else:
                o = L.attention(q, ck.transpose(1, 2), cv.transpose(1, 2),
                                causal=True, q_offset=pos,
                                kv_positions=kv_pos)
            return lay.local_heads(o)
        x = _mesh_attn_block(cfg, lay, _block(sspecs, "attn"), x,
                             _block(lp, "attn"), positions, attn_fn)
    if n_trail:
        tspecs = ML.stack_pspecs(pspecs, "trail")
        for j in range(n_trail):
            x = _mesh_rec_step(cfg, lay, tspecs, x, dict(flatten(
                T.layer(params["trail"], j))), T.layer(cache["trail"], j))
    logits = ML.last_logits(cfg, lay, params, pspecs, table, x)
    return logits, {**cache, "pos": pos + 1}
