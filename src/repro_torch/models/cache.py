"""Decode-state descriptors as ParamSpec trees (the reference's
`src/repro/models/cache.py`).

- dense: a KV cache (L, B, Hkv, Smax, Dh) in the activation dtype;
- ssm (Mamba-2): per layer the conv history (B, K-1, conv_dim) in the
  activation dtype and the SSD state (B, H, P, N) in float32;
- hybrid (RecurrentGemma): per recurrent block the RG-LRU state ``h``
  (B, W) in float32 and the conv history (B, K-1, W) in the activation
  dtype; per attention block a ring KV cache of ``local_window`` slots;
- encdec (Whisper): the decoder's KV cache and the cross-attention keys
  and values of the encoder memory.

The port keeps ``pos``, the number of positions seen, as a Python int
(the reference keeps an int32 scalar array), so a decode step needs no
device read to know where to write.
"""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.params import ParamSpec

_POS = ParamSpec((), (), init="zeros", dtype="int32")


def kv_cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                   n_layers: int = 0) -> dict:
    L = n_layers or cfg.n_layers
    kv_shape = (L, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    kv_axes = ("layers", "batch", None, "kv_seq", None)
    return {
        "k": ParamSpec(kv_shape, kv_axes, init="zeros", dtype=cfg.dtype),
        "v": ParamSpec(kv_shape, kv_axes, init="zeros", dtype=cfg.dtype),
        "pos": _POS,
    }


def ssm_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    L = cfg.n_layers
    conv_dim = cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
    return {
        "conv": ParamSpec((L, batch, cfg.ssm_conv_width - 1, conv_dim),
                          ("layers", "batch", None, "tp"), init="zeros",
                          dtype=cfg.dtype),
        "ssm": ParamSpec((L, batch, cfg.ssm_n_heads, cfg.ssm_head_dim,
                          cfg.ssm_state),
                         ("layers", "batch", "tp", None, None), init="zeros",
                         dtype="float32"),
        "pos": _POS,
    }


def hybrid_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    """RecurrentGemma: ``super`` (rec, rec, attn) superlayers, then the
    ``trail`` recurrent blocks (12 and 2 for the 9B)."""
    n_super = cfg.n_layers // len(cfg.block_pattern)
    n_trail = cfg.n_layers - n_super * len(cfg.block_pattern)
    lw, cw, W = cfg.lru_width, cfg.conv_width, cfg.local_window

    def rec_state(n):
        return {
            "h": ParamSpec((n, batch, lw), ("layers", "batch", "tp"),
                           init="zeros", dtype="float32"),
            "conv": ParamSpec((n, batch, cw - 1, lw),
                              ("layers", "batch", None, "tp"), init="zeros",
                              dtype=cfg.dtype),
        }
    kv = ParamSpec((n_super, batch, cfg.n_kv_heads, W, cfg.head_dim),
                   ("layers", "batch", None, "kv_seq", None), init="zeros",
                   dtype=cfg.dtype)
    out = {"super": {"rec1": rec_state(n_super), "rec2": rec_state(n_super),
                     "k": kv, "v": kv},
           "pos": _POS}
    if n_trail:
        out["trail"] = rec_state(n_trail)
    return out


def encdec_cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Whisper: the decoder's self-attention cache (L, B, Hkv, max_seq,
    Dh) and the encoder memory's cross-attention keys and values (L, B,
    Hkv, enc_seq, Dh), never padded."""
    L = cfg.n_layers
    self_shape = (L, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    cross_shape = (L, batch, cfg.n_kv_heads, cfg.enc_seq, cfg.head_dim)
    axes = ("layers", "batch", None, "kv_seq", None)
    return {
        "k": ParamSpec(self_shape, axes, init="zeros", dtype=cfg.dtype),
        "v": ParamSpec(self_shape, axes, init="zeros", dtype=cfg.dtype),
        "ck": ParamSpec(cross_shape, axes, init="zeros", dtype=cfg.dtype),
        "cv": ParamSpec(cross_shape, axes, init="zeros", dtype=cfg.dtype),
        "pos": _POS,
    }
