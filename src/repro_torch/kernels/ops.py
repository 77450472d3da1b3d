"""Kernel dispatch of the model path (the reference's `kernels/ops.py`).

The port dispatches as the reference does on a TPU, with the card in
the TPU's place. ``impl``:
  - "auto": the CUDA kernel where the reference takes its Pallas kernel
            on a TPU, for a CUDA tensor; the reference's CPU path
            otherwise and on the CPU;
  - "ref":  always the plain path.

  - `mha`: on the card, the flash kernel for self-attention (``q_offset
    == 0``, no ``kv_len`` or ``kv_positions``, more than one row), and
    under grad (grad enabled, an input requiring it) `FlashAttentionFn`,
    whose forward is the same kernel writing the row log-sum-exp and
    whose backward recomputes from it (the bf16 backward kernel at Dh 64
    and 128, else the reference's plain one). Otherwise the
    reference's CPU rule: `attention_ref` for one row, ring-buffer
    positions or Sq·Skv <= 1024²; above that `attention_flash` (self-
    attention) or `attention_chunked`.
  - `ssd`: on the card the SSD kernel when G == 1 and ``h0 is None``,
    and under grad `SSDScanFn` (the kernel forward, the reference's
    autodiff of `ssd_chunked`, float32 inside, recomputed as its
    backward); `ssd_chunked` otherwise and on the CPU.
  - `rglru`: on the card the RG-LRU kernel path (`rglru_gated`; under
    grad its scan is `RGLRUScanFn`, whose backward is the same kernel
    on the reversed recurrence); `rglru_assoc` on the CPU.
  - The decode steps and the causal conv are plain torch, as they are
    plain jnp in the reference.

Every "auto" call that the card serves with a kernel adds its work to
`cost.COUNTER` on both routes while the counter is on: the flash
attention of `mha` (with the log-sum-exp under grad), the SSD scan of
`ssd`, and the RG-LRU scan of `rglru` (its gates are plain torch on both
routes and stay outside the count; `RGLRUScanFn` counts its backward).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention)
from repro_torch.kernels.rglru_scan import rglru_gated
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan

IMPLS = ("auto", "ref")


def _check_impl(impl: str, op: str):
    if impl not in IMPLS:
        raise ValueError(f"unknown {op} impl {impl!r}; expected auto or ref")


def _on_card(impl: str, x: torch.Tensor, op: str) -> bool:
    """Whether "auto" sends a tensor on the card to the kernel."""
    _check_impl(impl, op)
    return impl == "auto" and x.device.type == "cuda"


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, q_offset=0, kv_len=None,
        kv_positions=None, impl: str = "auto") -> torch.Tensor:
    """GQA attention. q (B,Sq,Hq,Dh); k,v (B,Skv,Hkv,Dh)."""
    _check_impl(impl, "attention")
    (B, Sq, Hq, Dh), (Skv, Hkv) = q.shape, k.shape[1:3]
    self_attn = q_offset == 0 and kv_len is None and kv_positions is None
    if impl == "auto" and Sq > 1 and self_attn:     # the flash kernel's call
        with cost.COUNTER.count("flash_attention", lambda: cost.flash_attention(
                B, Sq, Skv, Hq, Hkv, Dh, q.element_size(), causal,
                window or 0, lse=R.needs_grad(q, k, v))):
            if _on_card(impl, q, "attention"):
                if R.needs_grad(q, k, v):
                    return FlashAttentionFn.apply(q, k, v, causal,
                                                  window or 0, None)
                return flash_attention(q, k, v, causal=causal,
                                       window=window or 0)
            if Sq * Skv > 1024 * 1024:
                return R.attention_flash(q, k, v, causal=causal,
                                         window=window)
            return R.attention_ref(q, k, v, causal=causal, window=window)
    if (impl == "auto" and Sq > 1 and kv_positions is None
            and Sq * Skv > 1024 * 1024):
        return R.attention_chunked(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
    return R.attention_ref(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, kv_len=kv_len,
                           kv_positions=kv_positions)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

def ssd(x, dt, a_log, b, c, d, *, h0=None, chunk: int = 256,
        impl: str = "auto"):
    """SSD scan. Returns (y, h_final); see `ref.ssd_ref` for semantics."""
    _check_impl(impl, "ssd")
    if impl == "auto" and b.shape[2] == 1 and h0 is None:   # the kernel's call
        with cost.COUNTER.count("ssd_scan", lambda: cost.ssd_scan(
                *x.shape, b.shape[3], chunk, x.element_size())):
            if _on_card(impl, x, "ssd"):
                if R.needs_grad(x, dt, a_log, b, c, d):
                    return SSDScanFn.apply(x, dt, a_log, b, c, d, chunk)
                return ssd_scan(x, dt, a_log, b, c, d, chunk=chunk)
            return R.ssd_chunked(x, dt, a_log, b, c, d, chunk=chunk)
    return R.ssd_chunked(x, dt, a_log, b, c, d, h0=h0, chunk=chunk)


def ssd_decode_step(x, dt, a_log, b, c, d, h):
    """Single-token SSD update. x (B,H,P), dt (B,H), b, c (B,G,N),
    h (B,H,P,N). Returns (y (B,H,P) in x.dtype, h float32)."""
    rep = x.shape[1] // b.shape[1]
    a = -torch.exp(a_log.float())
    bt = b.repeat_interleave(rep, dim=1).float()
    ct = c.repeat_interleave(rep, dim=1).float()
    dtf = dt.float()
    da = torch.exp(dtf * a[None, :])
    h = h.float() * da[..., None, None] + torch.einsum(
        "bhp,bhn,bh->bhpn", x.float(), bt, dtf)
    y = torch.einsum("bhpn,bhn->bhp", h, ct)
    y = y + x.float() * d.float()[None, :, None]
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def rglru(x, r, i, lam, *, h0=None, impl: str = "auto"):
    """Gated linear recurrence. Returns (h_seq, h_final)."""
    if _on_card(impl, x, "rglru"):
        return rglru_gated(x, r, i, lam, h0=h0)
    scan_scope = (cost.COUNTER.count("rglru_scan", lambda: cost.rglru_scan(
        *x.shape, x.element_size())) if impl == "auto" else None)
    return R.rglru_assoc(x, r, i, lam, h0=h0, scan_scope=scan_scope)


def rglru_decode_step(x, r, i, lam, h):
    """Single-token RG-LRU update. x, r, i (B,W); h (B,W). Returns
    (h in x.dtype, h float32)."""
    a, gx = R.rglru_gates(x, r, i, lam)
    h = a * h.float() + gx
    return h.to(x.dtype), h


# ---------------------------------------------------------------------------
# Causal depthwise conv1d
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, b=None, state=None):
    return R.causal_conv1d_ref(x, w, b, state)


def conv1d_decode_step(x, w, b, state):
    """x (B,C) one step; state (B,K-1,C). Returns (y (B,C), new state)."""
    xs = torch.cat([state.to(x.dtype), x[:, None, :]], dim=1)    # (B,K,C)
    y = torch.einsum("bkc,kc->bc", xs.float(), w.float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype), xs[:, 1:]
