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
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import softplus
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.cache import ssm_cache_specs
from repro_torch.models.params import ParamSpec, stack_specs


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
            pad_to: int = 0) -> tuple:
    """Process full prompts; return (last-position logits (B,V), cache).
    The state is O(1) in the sequence: ``pad_to`` is unused."""
    del pad_to
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
                tokens: torch.Tensor) -> tuple:
    """One decode step. tokens (B,); returns (logits (B,V), cache) with
    the layers' states updated in place."""
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
            remat: str = "none") -> tuple:
    """(loss, {"ce_loss"}): the chunked cross-entropy of `forward`."""
    x, _ = forward(cfg, params, batch["tokens"], remat=remat)
    loss = T.chunked_ce_loss(cfg, params, x, batch["labels"])
    return loss, {"ce_loss": loss}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    del max_seq  # O(1) state
    return ssm_cache_specs(cfg, batch)
