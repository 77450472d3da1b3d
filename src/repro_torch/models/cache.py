"""KV cache descriptor, as a ParamSpec tree (the reference's
`kv_cache_specs`).

Layout (L, B, Hkv, Smax, Dh) in the model's activation dtype, plus the
number of filled slots ``pos``. The port keeps ``pos`` as a Python int
(the reference keeps an int32 scalar array), so a decode step needs no
device read to know where to write.
"""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.params import ParamSpec


def kv_cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                   n_layers: int = 0) -> dict:
    L = n_layers or cfg.n_layers
    kv_shape = (L, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    kv_axes = ("layers", "batch", None, "kv_seq", None)
    return {
        "k": ParamSpec(kv_shape, kv_axes, init="zeros", dtype=cfg.dtype),
        "v": ParamSpec(kv_shape, kv_axes, init="zeros", dtype=cfg.dtype),
        "pos": ParamSpec((), (), init="zeros", dtype="int32"),
    }
