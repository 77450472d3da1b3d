"""Mamba-2 (SSD, state-space duality): parameter specs, prefill and decode
(the reference's `src/repro/models/mamba2.py`).

Block: in_proj -> [z | xBC | dt]; causal depthwise conv over xBC; the
SSD scan over heads (`ops.ssd`: the CUDA kernel on the card, under
grad inside its autograd Function); gated RMSNorm; out_proj. `loss_fn`
trains it as the dense module's does (the layers under the remat
policy, the chunked cross-entropy). Decode keeps O(1) state per layer: the
conv history (K-1 steps) and the SSD state (H, P, N) in float32.

As in the dense module, the layers are a Python loop over parameters
stacked on a leading ``L`` axis, with the reference's numerics: with
``cast_weights`` the whole ``layers`` subtree runs in the activation
dtype, ``a_log``, ``d_skip``, ``dt_bias``, the conv and ``gnorm``
included; ``final_norm`` stays float32 and the logits are in the
activation dtype. The decode step writes the new states into the cache
in place (the reference returns updated copies).

On a mesh (``mesh=``; `repro_torch.models.mesh_layers`) the heads split
over the model axis where it divides them (``a_log``'s "tp"): the
residual stream is laid out as in the dense module, ``in_proj`` is
taken whole (its columns z | xBC | dt do not follow the heads) and the
local heads' z and dt sliced from it, the conv runs over the whole xBC
(B and C are every head's), the SSD scan on the local heads, the gated
norm sums its squares over the heads' axes and ``out_proj`` is row-
parallel. The cache keeps `cache_pspecs`' layouts: the conv history's
chunk of conv_dim (which does not follow x | B | C) and the local
heads' SSD states; a decode step convolves its chunk and all-gathers
the conv output.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import softplus
from repro_torch.models import layers as L
from repro_torch.models import mesh_layers as ML
from repro_torch.models import transformer as T
from repro_torch.models.cache import ssm_cache_specs
from repro_torch.models.params import (ParamSpec, flatten, param_pspecs,
                                      stack_specs)
from repro_torch.models.sharding import redistribute, shard_range, spec_axes


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    gn = cfg.ssm_n_groups * cfg.ssm_state
    return di, gn, di + 2 * gn, cfg.ssm_n_heads


def layer_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, gn, conv_dim, h = _dims(cfg)
    return {
        "ln": L.norm_specs(d),
        "in_proj": ParamSpec((d, 2 * di + 2 * gn + h), ("fsdp", "tp"),
                             init="scaled"),
        "conv_w": ParamSpec((cfg.ssm_conv_width, conv_dim), (None, "tp"),
                            init="normal", scale=0.1),
        "conv_b": ParamSpec((conv_dim,), ("tp",), init="zeros"),
        "a_log": ParamSpec((h,), ("tp",), init="ssm_a"),
        "d_skip": ParamSpec((h,), ("tp",), init="ones"),
        "dt_bias": ParamSpec((h,), ("tp",), init="zeros"),
        "gnorm": ParamSpec((di,), ("tp",), init="zeros"),
        "out_proj": ParamSpec((di, d), ("tp", "fsdp"), init="scaled"),
    }


def specs(cfg: ModelConfig) -> dict:
    out = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("tp", "fsdp"),
                           init="normal"),
        "final_norm": L.norm_specs(cfg.d_model),
        "layers": stack_specs(cfg.n_layers, layer_specs(cfg)),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                   ("fsdp", "tp"), init="scaled")
    return out


def prepare(cfg: ModelConfig, params: dict) -> dict:
    return T.prepare(cfg, params)


def _gated_norm(y, z, w, eps):
    """RMSNormGated: rmsnorm(y * silu(z))."""
    return L.rmsnorm(y * L.silu(z.float()).to(y.dtype), w, eps)


def _mixer_seq(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               conv_state=None, ssm_state=None):
    """Full-sequence mixer. x (B,S,D) -> (y (B,S,D), conv_state', ssm_state')."""
    B, S, _ = x.shape
    di, gn, conv_dim, H = _dims(cfg)
    dtype = x.dtype
    proj = x @ lp["in_proj"].to(dtype)
    z, xbc, dt_raw = torch.split(proj, [di, conv_dim, H], dim=-1)
    xc, conv_new = ops.causal_conv1d(xbc, lp["conv_w"], lp["conv_b"],
                                     conv_state)
    xc = L.silu(xc.float()).to(dtype)
    xs, b, c = torch.split(xc, [di, gn, gn], dim=-1)
    dt = softplus(dt_raw.float() + lp["dt_bias"].float())
    y, ssm_new = ops.ssd(
        xs.reshape(B, S, H, cfg.ssm_head_dim), dt, lp["a_log"],
        b.reshape(B, S, cfg.ssm_n_groups, cfg.ssm_state),
        c.reshape(B, S, cfg.ssm_n_groups, cfg.ssm_state), lp["d_skip"],
        h0=ssm_state, chunk=cfg.ssm_chunk, impl=cfg.ssm_impl)
    y = _gated_norm(y.reshape(B, S, di), z, lp["gnorm"], cfg.norm_eps)
    return y @ lp["out_proj"].to(dtype), conv_new, ssm_new


def _mixer_step(cfg: ModelConfig, lp: dict, x: torch.Tensor, conv_state,
                ssm_state):
    """Single-token mixer. x (B,D); states carried."""
    B = x.shape[0]
    di, gn, conv_dim, H = _dims(cfg)
    dtype = x.dtype
    proj = x @ lp["in_proj"].to(dtype)
    z, xbc, dt_raw = torch.split(proj, [di, conv_dim, H], dim=-1)
    xc, conv_state = ops.conv1d_decode_step(xbc, lp["conv_w"], lp["conv_b"],
                                            conv_state)
    xc = L.silu(xc.float()).to(dtype)
    xs, b, c = torch.split(xc, [di, gn, gn], dim=-1)
    dt = softplus(dt_raw.float() + lp["dt_bias"].float())
    y, ssm_state = ops.ssd_decode_step(
        xs.reshape(B, H, cfg.ssm_head_dim), dt, lp["a_log"],
        b.reshape(B, cfg.ssm_n_groups, cfg.ssm_state),
        c.reshape(B, cfg.ssm_n_groups, cfg.ssm_state), lp["d_skip"],
        ssm_state)
    y = _gated_norm(y.reshape(B, 1, di), z[:, None, :], lp["gnorm"],
                    cfg.norm_eps)[:, 0]
    return y @ lp["out_proj"].to(dtype), conv_state, ssm_state


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
    layers = T.run_layers(cfg, params)
    conv, ssm = [], []
    for i in range(cfg.n_layers):
        lp = T.layer(layers, i)
        y, conv_s, ssm_s = _mixer_seq(cfg, lp, L.apply_norm(
            x, lp["ln"], cfg.norm_eps))
        x = x + y
        conv.append(conv_s)
        ssm.append(ssm_s)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_eps)
    logits = T.unembed(cfg, params, x[:, -1:, :])[:, 0]
    return logits, {"conv": torch.stack(conv), "ssm": torch.stack(ssm),
                    "pos": S}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, mesh=None) -> tuple:
    """One decode step. tokens (B,); returns (logits (B,V), cache) with
    the layers' states updated in place. On a mesh, this process's
    shards in and out (`_mesh_decode`)."""
    if mesh is not None:
        return _mesh_decode(cfg, params, cache, tokens, mesh)
    x = T.embed_tokens(cfg, params, tokens[:, None])[:, 0]        # (B,D)
    layers = T.run_layers(cfg, params)
    conv, ssm = cache["conv"], cache["ssm"]
    for i in range(cfg.n_layers):
        lp = T.layer(layers, i)
        y, conv_s, ssm_s = _mixer_step(cfg, lp, L.apply_norm(
            x, lp["ln"], cfg.norm_eps), conv[i], ssm[i])
        conv[i] = conv_s
        ssm[i] = ssm_s
        x = x + y
    x = L.apply_norm(x, params["final_norm"], cfg.norm_eps)
    logits = T.unembed(cfg, params, x[:, None, :])[:, 0]
    return logits, {"conv": conv, "ssm": ssm, "pos": int(cache["pos"]) + 1}


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            remat: str = "none") -> tuple:
    """tokens (B,S) -> (final hidden states (B,S,D) pre-unembed, 0): the
    layers, each under the `remat` policy (`transformer.maybe_remat`)."""
    x = T.embed_tokens(cfg, params, tokens)

    def body(x, lp):
        y, _, _ = _mixer_seq(cfg, lp, L.apply_norm(x, lp["ln"], cfg.norm_eps))
        return x + y

    step = T.maybe_remat(body, remat)
    for lp in T.unbind_layers(T.run_layers(cfg, params), cfg.n_layers):
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
    del max_seq  # O(1) state
    return ssm_cache_specs(cfg, batch)


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

def _mesh_mixer_seq(cfg: ModelConfig, lay: ML.Layout, specs: dict, h, lp):
    """`_mixer_seq` on local shards: h (B_local, S, D), whole over the
    model axis -> (y, a partial sum over the heads' axes; the whole conv
    state (B, K-1, conv_dim); the SSD state of the local heads).

    ``in_proj``'s columns (z | xBC | dt) do not follow the heads, so the
    projection is taken whole (its weight gathered) and the local heads'
    z and dt sliced from it; the conv runs on the whole xBC, whose B and
    C every head shares (G = 1); the SSD scan (the kernel on the card)
    runs on the local heads with B and C whole; the gated RMSNorm sums
    its squares over the heads' axes; ``out_proj`` is row-parallel."""
    B, S, _ = h.shape
    di, gn, conv_dim, H = _dims(cfg)
    P = cfg.ssm_head_dim
    heads = spec_axes(specs["a_log"][0])
    h0, nh = shard_range(specs["a_log"][0], H, lay.mesh)
    w = lay.layer_weights(lp, specs)
    dtype = h.dtype
    proj = h @ w("in_proj", partial=heads).to(dtype)
    z = proj[..., h0 * P:(h0 + nh) * P]
    xbc = proj[..., di:di + conv_dim]
    dt_raw = proj[..., di + conv_dim + h0:di + conv_dim + h0 + nh]
    xc, conv_new = ops.causal_conv1d(xbc, w("conv_w", partial=heads),
                                     w("conv_b", partial=heads))
    xc = L.silu(xc.float()).to(dtype)
    xs = xc[..., h0 * P:(h0 + nh) * P]
    b, c = xc[..., di:di + gn], xc[..., di + gn:]
    dt = softplus(dt_raw.float() + w("dt_bias", keep=heads).float())
    y, ssm_new = ops.ssd(
        xs.reshape(B, S, nh, P), dt, w("a_log", keep=heads),
        b.reshape(B, S, cfg.ssm_n_groups, cfg.ssm_state),
        c.reshape(B, S, cfg.ssm_n_groups, cfg.ssm_state),
        w("d_skip", keep=heads), chunk=cfg.ssm_chunk, impl=cfg.ssm_impl)
    y = _mesh_gated_norm(cfg, lay, y.reshape(B, S, nh * P), z,
                         w("gnorm", keep=heads), heads)
    return y @ w("out_proj", keep=heads).to(dtype), conv_new, ssm_new


def _mesh_gated_norm(cfg: ModelConfig, lay: ML.Layout, y, z, w, heads):
    """`_gated_norm` of the local heads' channels: the mean of squares
    over all of d_inner, its sum taken over the heads' axes."""
    if not heads:
        return _gated_norm(y, z, w, cfg.norm_eps)
    g = (y * L.silu(z.float()).to(y.dtype)).float()
    ss = ML.sum_over((g * g).sum(-1, keepdim=True), lay.mesh, heads)
    out = g * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps) * (1.0 + w.float())
    return out.to(y.dtype)


def _mesh_block(cfg: ModelConfig, lay: ML.Layout, specs: dict, x, lp):
    """x + mixer(norm(x)) on local shards, x in the residual layout ->
    (x, whole conv state, local SSD state)."""
    heads = spec_axes(specs["a_log"][0])
    h = lay.norm(x, lp, specs, "ln", partial=lay.sp)
    h = lay.to(h, ML.FULL, lay.res, grad_partial=heads)
    y, conv_s, ssm_s = _mesh_mixer_seq(cfg, lay, specs, h, lp)
    return x + lay.to(y, lay.res, ML.FULL, partial=heads), conv_s, ssm_s


def _mesh_loss(cfg: ModelConfig, params: dict, batch: dict, remat: str,
               mesh) -> tuple:
    """`loss_fn` on local shards: this process's share of the loss, the
    global ce_loss as the metric."""
    tokens = batch["tokens"]
    B_local, S = tokens.shape
    lay = ML.Layout(cfg, mesh, B_local * math.prod(
        mesh.size(a) for a in mesh.batch), S)
    pspecs = param_pspecs(specs(cfg), mesh)
    lspecs = ML.stack_pspecs(pspecs, "layers")
    table = ML.embed_table(lay, params, pspecs)
    x = ML.embed(cfg, lay, table, tokens)

    def body(x, lp):
        return _mesh_block(cfg, lay, lspecs, x, dict(flatten(lp)))[0]

    step = T.maybe_remat(body, remat)
    for lp in T.unbind_layers(params["layers"], cfg.n_layers):
        x = step(x, lp)
    share, ce = ML.loss_head(cfg, lay, params, pspecs, table, x,
                             batch["labels"])
    return share, {"ce_loss": ce}


def _mesh_prefill(cfg: ModelConfig, params: dict, batch: dict,
                  mesh) -> tuple:
    """`prefill` on local shards: this process's prompt rows in, its
    logits (rows, vocabulary) out, and its shard of the cache: the conv
    history's chunk of conv_dim and the local heads' SSD states."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    lay, pspecs, table, x, B = ML.serve_setup(cfg, specs(cfg), params,
                                              tokens, S, mesh)
    lspecs = ML.stack_pspecs(pspecs, "layers")
    _, c0, nc = ML.cache_chunk(ssm_cache_specs(cfg, B)["conv"], 3, mesh)
    conv, ssm = [], []
    for i in range(cfg.n_layers):
        x, conv_s, ssm_s = _mesh_block(cfg, lay, lspecs, x, dict(flatten(
            T.layer(params["layers"], i))))
        conv.append(conv_s[..., c0:c0 + nc])
        ssm.append(ssm_s)
    logits = ML.last_logits(cfg, lay, params, pspecs, table, x)
    return logits, {"conv": torch.stack(conv), "ssm": torch.stack(ssm),
                    "pos": S}


def _mesh_mixer_step(cfg: ModelConfig, lay: ML.Layout, specs: dict, h, lp,
                     conv_state, ssm_state, conv_chunk: tuple):
    """`_mixer_step` on local shards: h (B_local, D). The conv steps this
    process's chunk of conv_dim (its cache shard, updated in place) and
    its output is all-gathered whole; the SSD step runs on the local
    heads (their state updated in place). Returns y, a partial sum over
    the heads' axes."""
    B = h.shape[0]
    di, gn, conv_dim, H = _dims(cfg)
    P = cfg.ssm_head_dim
    heads = spec_axes(specs["a_log"][0])
    h0, nh = shard_range(specs["a_log"][0], H, lay.mesh)
    entry, c0, nc = conv_chunk
    w = lay.layer_weights(lp, specs)
    dtype = h.dtype
    proj = h @ w("in_proj").to(dtype)
    z = proj[:, h0 * P:(h0 + nh) * P]
    dt_raw = proj[:, di + conv_dim + h0:di + conv_dim + h0 + nh]
    keep = spec_axes(entry)
    xc, conv_new = ops.conv1d_decode_step(
        proj[:, di + c0:di + c0 + nc], w("conv_w", keep=keep),
        w("conv_b", keep=keep), conv_state)
    conv_state.copy_(conv_new)
    xc = redistribute(xc, (None, entry), (None, None), lay.mesh)
    xc = L.silu(xc.float()).to(dtype)
    xs = xc[:, h0 * P:(h0 + nh) * P]
    b, c = xc[:, di:di + gn], xc[:, di + gn:]
    dt = softplus(dt_raw.float() + w("dt_bias", keep=heads).float())
    y, ssm_new = ops.ssd_decode_step(
        xs.reshape(B, nh, P), dt, w("a_log", keep=heads),
        b.reshape(B, cfg.ssm_n_groups, cfg.ssm_state),
        c.reshape(B, cfg.ssm_n_groups, cfg.ssm_state),
        w("d_skip", keep=heads), ssm_state)
    ssm_state.copy_(ssm_new)
    y = _mesh_gated_norm(cfg, lay, y.reshape(B, 1, nh * P), z[:, None],
                         w("gnorm", keep=heads), heads)
    return y @ w("out_proj", keep=heads).to(dtype)


def _mesh_decode(cfg: ModelConfig, params: dict, cache: dict, tokens,
                 mesh) -> tuple:
    """`decode_step` on local shards: this process's rows of the tokens
    in, its logits (rows, vocabulary) out, its cache shard updated in
    place."""
    lay, pspecs, table, x, B = ML.serve_setup(cfg, specs(cfg), params,
                                              tokens[:, None], 1, mesh)
    lspecs = ML.stack_pspecs(pspecs, "layers")
    chunk = ML.cache_chunk(ssm_cache_specs(cfg, B)["conv"], 3, mesh)
    conv, ssm = cache["conv"], cache["ssm"]
    for i in range(cfg.n_layers):
        lp = dict(flatten(T.layer(params["layers"], i)))
        h = lay.norm(x, lp, lspecs, "ln")[:, 0]
        y = _mesh_mixer_step(cfg, lay, lspecs, h, lp, conv[i], ssm[i], chunk)
        x = x + lay.to(y, ML.FULL, ML.FULL,
                       partial=spec_axes(lspecs["a_log"][0]))
    logits = ML.last_logits(cfg, lay, params, pspecs, table, x)
    return logits, {"conv": conv, "ssm": ssm, "pos": int(cache["pos"]) + 1}
