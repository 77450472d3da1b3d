"""Plain PyTorch oracles for the model kernels (attention, so far).

The semantic ground truth of the port's model path: the CUDA flash
kernel is held against `attention_ref` on the card, the model's decode
step uses it directly, and on the CPU it is what every attention runs.
Ported from the reference's `repro.kernels.ref` (``_attn_mask``,
``attention_ref``).
"""
from __future__ import annotations

from typing import Optional

import torch

# A finite "minus infinity": a fully masked row gives uniform weights,
# not NaN, exactly as in the reference.
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _attn_mask(sq: int, skv: int, q_offset, kv_len, causal: bool, window: int,
               kv_positions=None, device=None) -> torch.Tensor:
    """(sq, skv) boolean mask of allowed attention edges (True = keep)."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]     # (sq, 1)
    if kv_positions is None:
        kv_pos = torch.arange(skv, device=device)[None, :]          # (1, skv)
    else:
        kv_pos = torch.as_tensor(kv_positions, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos <= q_pos
    if window and window > 0:
        mask &= kv_pos > q_pos - window
    if kv_len is not None:
        mask &= kv_pos < kv_len
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset=0, kv_len=None, kv_positions=None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Materializing GQA attention.

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh); Hq % Hkv == 0.
    q_offset: absolute position of q[0].
    kv_len:   number of valid KV entries (for partially-filled caches).
    kv_positions: (Skv,) absolute positions of KV entries (ring buffers).
    Softmax in float32; the output is in q's dtype.
    """
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, Dh).float() * scale
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())  # (B,Hkv,G,Sq,Skv)
    mask = _attn_mask(Sq, Skv, q_offset, kv_len, causal, window, kv_positions,
                      device=q.device)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(B, Sq, Hq, Dh).to(q.dtype)
