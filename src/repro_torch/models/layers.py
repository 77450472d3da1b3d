"""Shared layer primitives: norms, RoPE, MLP variants, attention dispatch.

Plain functions on tensors and parameter dicts, with the reference's
numerics (`src/repro/models/layers.py`): norms in float32 with the
result in the input's dtype, RMSNorm scale ``(1 + w)``, half-split RoPE
with float32 angles, SiLU and tanh-approximated GELU written as
``jax.nn`` writes them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.config import GEGLU, GELU, SWIGLU, ModelConfig
from repro_torch.devmath import divide
from repro_torch.kernels import ops
from repro_torch.models.params import ParamSpec, tree_map


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()
    return out.to(x.dtype)


def norm_specs(d: int, kind: str = "rms") -> dict:
    if kind == "rms":
        return {"scale": ParamSpec((d,), (None,), init="zeros")}
    return {"scale": ParamSpec((d,), (None,), init="ones"),
            "bias": ParamSpec((d,), (None,), init="zeros")}


def apply_norm(x, p, eps):
    if "bias" in p:
        return layernorm(x, p["scale"], p["bias"], eps)
    return rmsnorm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, Dh), positions: (S,) or (B, S). Half-split rotation."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        ang = pos[None, :, None] * freqs[None, None, :]
    else:
        ang = pos[:, :, None] * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]                  # (B,S,1,half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_frequencies(d: int, device=None) -> torch.Tensor:
    """exp(-log(10000) · arange(d/2) / (d/2 − 1)) in float32, in the
    reference's op order (its ``log(10000.0)`` is a float32 log; the
    quotient is the IEEE one on the card too)."""
    half = d // 2
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                      device=device))
    steps = torch.arange(half, dtype=torch.float32, device=device)
    return torch.exp(divide(-log_base * steps, half - 1))


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (S, d), float32: sin
    then cos of position · frequency."""
    freqs = sinusoidal_frequencies(d, device)
    pos = torch.arange(seq, dtype=torch.float32, device=device)
    ang = pos[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d: Optional[int] = None,
              f: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    f = f or cfg.d_ff
    if cfg.mlp_variant in (SWIGLU, GEGLU):
        return {"wg": ParamSpec((d, f), ("fsdp", "tp"), init="scaled"),
                "wi": ParamSpec((d, f), ("fsdp", "tp"), init="scaled"),
                "wo": ParamSpec((f, d), ("tp", "fsdp"), init="scaled")}
    return {"wi": ParamSpec((d, f), ("fsdp", "tp"), init="scaled"),
            "wo": ParamSpec((f, d), ("tp", "fsdp"), init="scaled")}


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s op sequence, so bf16 rounds where it rounds."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU (``jax.nn.gelu``'s default), in its op
    sequence and with its constants rounded to x's dtype, so bf16 rounds
    where it rounds."""
    c = float(torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype))
    k = float(torch.tensor(0.044715, dtype=x.dtype))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def mlp(x: torch.Tensor, p: dict, variant: str, dtype) -> torch.Tensor:
    xc = x.to(dtype)
    if variant == SWIGLU:
        h = silu(xc @ p["wg"].to(dtype)) * (xc @ p["wi"].to(dtype))
    elif variant == GEGLU:
        h = gelu(xc @ p["wg"].to(dtype)) * (xc @ p["wi"].to(dtype))
    elif variant == GELU:
        h = gelu(xc @ p["wi"].to(dtype))
    else:
        raise ValueError(variant)
    return h @ p["wo"].to(dtype)


# ---------------------------------------------------------------------------
# Attention block (projection + RoPE + kernel dispatch)
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {"wq": ParamSpec((d, hq * dh), ("fsdp", "tp"), init="scaled"),
           "wk": ParamSpec((d, hkv * dh), ("fsdp", "tp"), init="scaled"),
           "wv": ParamSpec((d, hkv * dh), ("fsdp", "tp"), init="scaled"),
           "wo": ParamSpec((hq * dh, d), ("tp", "fsdp"), init="scaled")}
    if cfg.qk_norm:
        out["qnorm"] = ParamSpec((dh,), (None,), init="zeros")
        out["knorm"] = ParamSpec((dh,), (None,), init="zeros")
    return out


def qkv_project(cfg: ModelConfig, p: dict, x: torch.Tensor, positions) -> tuple:
    """x: (B,S,D) -> q (B,S,Hq,Dh), k,v (B,S,Hkv,Dh), RoPE applied."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    dtype = x.dtype
    q = (x @ p["wq"].to(dtype)).reshape(B, S, cfg.n_heads, dh)
    k = (x @ p["wk"].to(dtype)).reshape(B, S, cfg.n_kv_heads, dh)
    v = (x @ p["wv"].to(dtype)).reshape(B, S, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["qnorm"], cfg.norm_eps)
        k = rmsnorm(k, p["knorm"], cfg.norm_eps)
    if cfg.use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(q, k, v, *, causal=True, window=0, q_offset=0, kv_len=None,
              kv_positions=None, impl: str = "auto") -> torch.Tensor:
    """The CUDA flash kernel (prefill on the card) or the plain path."""
    return ops.mha(q, k, v, causal=causal, window=window, q_offset=q_offset,
                   kv_len=kv_len, kv_positions=kv_positions, impl=impl)


def output_project(cfg: ModelConfig, p: dict, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[0], o.shape[1]
    o = o.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return o @ p["wo"].to(o.dtype)


def residual_axes(cfg: ModelConfig) -> tuple:
    """Logical axes of the residual stream between layers (train path):
    with ``seq_shard`` its sequence is split over the model axis
    (Megatron's sequence parallelism) and gathered at attention and the
    MLP."""
    return ("batch", "sp" if cfg.seq_shard else "seq", None)


def cast_tree(tree, dtype: torch.dtype):
    """Cast the floating leaves of a parameter dict to `dtype` (a leaf
    already in `dtype` is returned as it is, without a copy)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)
