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
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.cache import hybrid_cache_specs
from repro_torch.models.params import ParamSpec, stack_specs

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
            pad_to: int = 0) -> tuple:
    """Process full prompts; return (last-position logits (B,V), cache).
    The state is O(1) in the sequence: ``pad_to`` is unused."""
    del pad_to
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
                tokens: torch.Tensor) -> tuple:
    """One decode step. tokens (B,); returns (logits (B,V), cache) with
    the states and the ring caches updated in place."""
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
            remat: str = "none") -> tuple:
    """(loss, {"ce_loss"}): the chunked cross-entropy of `forward`."""
    x, _ = forward(cfg, params, batch["tokens"], remat=remat)
    loss = T.chunked_ce_loss(cfg, params, x, batch["labels"])
    return loss, {"ce_loss": loss}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    del max_seq  # O(1)-in-sequence state (window-bounded KV)
    return hybrid_cache_specs(cfg, batch)
