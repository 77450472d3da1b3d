"""Attention dispatch of the model path (the reference's `kernels/ops.mha`).

``impl`` (the model config's ``attn_impl``):
  - "auto": the plain `attention_ref` for decode (one query row, or ring
            positions) and on the CPU; the CUDA flash kernel for a prefill
            on the card (``q_offset == 0``, no ``kv_len``), as the
            reference takes its Pallas kernel on a TPU exactly there;
  - "ref":  always the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import attention_ref


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, q_offset=0, kv_len=None,
        kv_positions=None, impl: str = "auto") -> torch.Tensor:
    """GQA attention. q (B,Sq,Hq,Dh); k,v (B,Skv,Hkv,Dh)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown attention impl {impl!r}; expected auto "
                         f"or ref")
    if (impl == "auto" and q.device.type == "cuda" and q.shape[1] > 1
            and q_offset == 0 and kv_len is None and kv_positions is None):
        return flash_attention(q, k, v, causal=causal, window=window or 0)
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, kv_len=kv_len,
                         kv_positions=kv_positions)
