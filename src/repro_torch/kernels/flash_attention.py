"""Forward GQA flash attention: the CUDA kernel, its plain PyTorch
version, and the autograd Function that trains through it.

`flash_attention` replaces the Pallas TPU kernel of the same name
(`src/repro/kernels/flash_attention.py:78`). On a CUDA tensor it
launches one of the hand-written sm_90a kernels in
``csrc/flash_attention.cu`` (one launch; see the source for the designs
and their bound) or raises. `ROUTES` names the kernel for each (dtype,
Dh): ``"wgmma"`` (bf16 on the tensor cores, TMA-fed) or ``"cuda_core"``
(f32 arithmetic, which keeps float32 exact); a pair the table does not
list raises. With ``return_lse`` the kernel also writes each row's
log-sum-exp (float32, (B, Hq, Sq)). On a CPU tensor it runs
`flash_attention_torch`, the plain version (`attention_ref`; with the
log-sum-exp, the blocked `ref.flash_fwd_torch`); the plain version is
also what the kernel is held against on the card.

The forward kernel has no autograd node of its own: on the card it
raises when autograd would need one (grad enabled and an input requiring
grad), rather than return an output cut from the graph. Training goes
through `FlashAttentionFn`: its forward is this wrapper with the
log-sum-exp (the kernel on the card), its backward
`flash_attention_backward`. That takes the hand-written sm_90a backward
in ``csrc/flash_attention_bwd.cu`` (dq, dk, dv on wgmma from the lse,
three launches, the same bits from run to run) for a CUDA tensor whose
(dtype, Dh) is in `BACKWARD_KERNEL`, and otherwise the reference's recomputing
backward (`ref.flash_bwd_torch`: `_flash_bwd_inner` at the reference's
blocks, plain torch in float32, as the reference computes it outside any
Pallas kernel), which is also what the kernel is held against.

`flash_attention.launches` counts kernel launches and
`flash_attention.route_launches` the launches per route, with a
``"+lse"`` suffix for launches that write the log-sum-exp;
`flash_attention_backward.launches` counts the backward kernel's calls.
CPU calls do not count.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch import cuda_build
from repro_torch.kernels import cost
from repro_torch.kernels.ref import (attention_ref, flash_bwd_torch,
                                     flash_fwd_torch, needs_grad)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (dtype, Dh) -> the kernel that serves it on the card
ROUTES = {
    **{(torch.float32, dh): "cuda_core" for dh in (16, 32, 64, 128, 256)},
    **{(torch.bfloat16, dh): "cuda_core" for dh in (16, 32)},
    **{(torch.bfloat16, dh): "wgmma" for dh in (64, 128, 256)},
}


# the (dtype, Dh) pairs whose backward the card's kernel serves: bf16 at Dh
# 64 and 128. Every other pair takes the plain float32 backward: float32
# (which keeps the 1e-4 bars), bf16 at Dh 16 and 32 (too narrow for wgmma's
# 64-column boxes) and bf16 at Dh 256 (dK and dV would take 256 f32
# registers a thread)
BACKWARD_KERNEL = {(torch.bfloat16, 64), (torch.bfloat16, 128)}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves (dtype, Dh) on the card; raises if none."""
    try:
        return ROUTES[(dtype, head_dim)]
    except KeyError:
        raise ValueError(f"no CUDA flash kernel for {dtype} at Dh = "
                         f"{head_dim}; the table serves "
                         f"{sorted((str(d)[6:], h) for d, h in ROUTES)}"
                         ) from None


def backward_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward of (dtype, Dh) on the card: ``"wgmma"`` (the kernel)
    for a pair of `BACKWARD_KERNEL`, else ``"plain"``
    (`ref.flash_bwd_torch`)."""
    return "wgmma" if (dtype, head_dim) in BACKWARD_KERNEL else "plain"


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """Plain PyTorch version of `flash_attention` (same contract)."""
    if return_lse:
        return flash_fwd_torch(q, k, v, causal, window, scale)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B,Sq,Hq,Dh) and k, v "
                         "(B,Skv,Hkv,Dh)")
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    if tuple(k.shape) != (B, Skv, Hkv, Dh) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq = {Hq} is not a multiple of Hkv = {Hkv}")
    if Sq == 0 or Skv == 0:
        raise ValueError("flash_attention needs Sq >= 1 and Skv >= 1")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16, one "
                         f"dtype for q, k, v; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


@functools.cache
def _library():
    """The built kernel library with its C signature declared."""
    lib = cuda_build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        i, i, ctypes.c_float, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_fwd_wgmma.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                              i, i, i, ctypes.c_float, p]
    lib.flash_attention_fwd_wgmma.restype = i
    return lib


@functools.cache
def _backward_library():
    """The built backward kernel with its C signature declared."""
    lib = cuda_build.load("flash_attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_wgmma.argtypes = [p] * 13 + [i] * 8 + [
        ctypes.c_float, p]
    lib.flash_attention_bwd_wgmma.restype = i
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, return_lse: bool = False):
    """q (B,Sq,Hq,Dh); k, v (B,Skv,Hkv,Dh) -> (B,Sq,Hq,Dh) in q's dtype,
    and with `return_lse` also lse (B,Hq,Sq) float32: the natural log of
    each row's sum of exp(scale·q·k) over its kept keys.

    Causal and sliding-window (``window > 0``: keys within the last
    `window` positions) masks; scale defaults to Dh**-0.5. float32 or
    bfloat16, contiguous; on the card a (dtype, Dh) pair of `ROUTES`,
    and no input that needs a gradient (see `FlashAttentionFn`).
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     scale=scale, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    if needs_grad(q, k, v):
        raise RuntimeError("the flash kernel has no backward and would cut "
                           "the autograd graph; train through "
                           "FlashAttentionFn (ops.mha does so under grad)")
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    path = route(q.dtype, Dh)
    if path == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the wgmma kernel's TMA loads need q, k and v "
                         "16-byte aligned")
    scale = scale if scale is not None else Dh ** -0.5
    lib = _library()
    out = torch.empty_like(q)
    lse = (torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None)
    mask = (int(bool(causal)), int(window), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if path == "wgmma":
            err = lib.flash_attention_fwd_wgmma(*ptrs, B, Sq, Skv, Hq, Hkv,
                                                Dh, *mask, stream)
        else:
            err = lib.flash_attention_fwd(*ptrs, DTYPE_CODES[q.dtype], B, Sq,
                                          Skv, Hq, Hkv, Dh, *mask, stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed ({path}): error "
                           f"{err}")
    flash_attention.launches += 1
    flash_attention.route_launches[path + ("+lse" if return_lse else "")] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(
    sorted(r + lse for r in set(ROUTES.values()) for lse in ("", "+lse")), 0)

# the reference's blocking of its custom-VJP flash attention
# (`src/repro/kernels/ref.py:254`), which the backward keeps
Q_BLOCK, KV_BLOCK = 512, 1024


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: int = 0, scale: Optional[float] = None):
    """(dq, dk, dv) of `flash_attention` from the saved (q, k, v, out,
    lse (B,Hq,Sq) float32) and dout, in the dtypes of q, k, v.

    On a CUDA tensor whose (dtype, Dh) is in `BACKWARD_KERNEL`: the kernel
    of ``csrc/flash_attention_bwd.cu`` (a pre-pass for delta =
    rowsum(dout·out), the products, dq rounded from its f32 accumulator:
    three launches; see the source). Its dq sums the key blocks in a fixed
    order, so the same inputs give the same bits. Inside
    `cost.COUNTER.on()` a kernel call counts as ``flash_attention_bwd``.
    Otherwise, and for every CPU tensor, the plain version
    `ref.flash_bwd_torch` in float32 at the reference's blocks (its aten
    ops are what a cost probe sees). q and kv positions both start at 0.
    """
    scale = scale if scale is not None else q.shape[3] ** -0.5
    B, Sq, Hq, Dh = q.shape
    if q.device.type != "cuda" or backward_route(q.dtype, Dh) == "plain":
        return flash_bwd_torch(q, k, v, out, lse, dout, causal, window,
                               scale, Q_BLOCK, KV_BLOCK)
    _check(q, k, v)
    dout = dout.contiguous()
    if (out.shape != q.shape or dout.shape != q.shape
            or out.dtype != q.dtype or dout.dtype != q.dtype
            or not out.is_contiguous()):
        raise ValueError("the backward kernel takes out and dout contiguous, "
                         "of q's shape and dtype")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, Sq)
            or not lse.is_contiguous()):
        raise ValueError("the backward kernel takes lse (B, Hq, Sq) float32, "
                         "contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("the backward kernel's TMA loads need q, k, v, out "
                         "and dout 16-byte aligned")
    Skv, Hkv = k.shape[1], k.shape[2]
    sq_pad = -(-Sq // 64) * 64
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.empty(B, Hq, sq_pad, Dh, **f32)
    lse_pad = torch.empty(B, Hq, sq_pad, **f32)
    delta = torch.empty(B, Hq, sq_pad, **f32)
    order = torch.empty(B, Hq, sq_pad // 64, dtype=torch.int32,
                        device=q.device)
    lib = _backward_library()
    with torch.cuda.device(q.device), cost.COUNTER.count(
            "flash_attention_bwd", lambda: cost.attention_backward(
                B, Sq, Skv, Hq, Hkv, Dh, q.element_size(), causal, window)):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_wgmma(
            *(t.data_ptr() for t in (q, k, v, out, lse, dout, dq, dk, dv,
                                     dq_acc, lse_pad, delta, order)),
            B, Sq, Skv, Hq, Hkv, Dh, int(bool(causal)), int(window or 0),
            float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_backward launch failed: error "
                           f"{err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention under autograd: the forward is `flash_attention`
    writing (out, lse) (the kernel on the card, its plain version on the
    CPU); the backward is `flash_attention_backward` on (q, k, v, out,
    lse, dout): the backward kernel for bf16 at Dh 64 and 128 on the
    card, else the reference's `_flash_bwd_inner` in float32 at the
    reference's blocks (`ref.flash_bwd_torch`). q and kv positions both
    start at 0: a self-attention, or a non-causal cross-attention (Sq !=
    Skv; both backwards mask the keys they pad).

        out = FlashAttentionFn.apply(q, k, v, causal, window, scale)
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        scale = scale if scale is not None else q.shape[3] ** -0.5
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              causal=causal, window=window,
                                              scale=scale)
        return dq, dk, dv, None, None, None
