"""RG-LRU recurrence: the CUDA kernel, its plain PyTorch version and the
gated wrapper.

`rglru_scan` replaces the Pallas TPU kernel `rglru_scan_pallas`
(`src/repro/kernels/rglru_scan.py:48`): h_t = a_t·h_{t-1} + gx_t from h0,
with a float32 state. On a CUDA tensor it launches the hand-written
sm_90a kernel in ``csrc/rglru_scan.cu`` or raises. `ROUTES` names the
kernel for each (dtype of ``a``, whether TMA can read ``a`` and ``gx``):
``"ring"`` (W a multiple of 8 and both 16-byte aligned: TMA streams
tiles of ``a`` and ``gx`` through a ring in shared memory) or
``"column"`` (any W: one thread per (b, w) column loading from device
memory). Both walk t one column per thread with the plain version's
roundings, so both give its bits. On a CPU tensor it runs
`rglru_scan_torch`, the plain version, which is also what the kernel is
held against on the card.

`rglru_gated` is the counterpart of the reference's `rglru_pallas`
wrapper (`:87`): the gates are computed outside the kernel, and ``a`` is
cast to the input's dtype before the scan (`:101`), so in bfloat16 this
path rounds ``a`` where the reference's CPU path (`rglru_assoc`) does not.

Training goes through `RGLRUScanFn`, whose forward is `rglru_scan` and
whose backward is the same kernel on the time-reversed recurrence of
the gradients (`ref.rglru_scan_bwd_torch` is its plain version). Under
grad `rglru_gated` takes the gates by plain autograd and scans through
the Function. The raw `rglru_scan` raises on the card when autograd
would need a backward (grad enabled and an input requiring grad) rather
than return outputs cut from the graph.

While `cost.COUNTER` is on, `rglru_gated` adds the scan's work to it
(its gates stay outside the count), and `RGLRUScanFn.backward` the
backward's, on both routes.

`rglru_scan.launches` counts kernel launches and
`rglru_scan.route_launches` those launches per route; CPU calls do not
count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import cuda_build
from repro_torch.kernels import cost
from repro_torch.kernels.ref import (needs_grad, rglru_gates,
                                    rglru_grads_from_g, rglru_scan_bwd_torch)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TMA_ALIGN = 8           # TMA needs 16-byte strides: W a multiple of 8
# (dtype of a, TMA can read a and gx) -> kernel
ROUTES = {(torch.float32, True): "ring", (torch.bfloat16, True): "ring",
          (torch.float32, False): "column", (torch.bfloat16, False): "column"}


def route(a: torch.Tensor, gx: torch.Tensor) -> str:
    """The kernel that runs ``a`` and ``gx`` (B,S,W), read from their
    dtype, W and addresses without launching; raises for a dtype that
    `ROUTES` does not list."""
    tma = (a.shape[2] % TMA_ALIGN == 0 and a.data_ptr() % 16 == 0
           and gx.data_ptr() % 16 == 0)
    if (a.dtype, tma) not in ROUTES:
        raise ValueError(f"rglru_scan has no kernel for a in {a.dtype}; "
                         f"routes: {sorted({str(d)[6:] for d, _ in ROUTES})}")
    return ROUTES[(a.dtype, tma)]


def rglru_scan_torch(a, gx, h0):
    """Plain PyTorch version of `rglru_scan` (same contract)."""
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + gx[:, t].float()
        hs.append(h)
    return torch.stack(hs, 1).to(gx.dtype), h


def _check(a, gx, h0):
    if a.dim() != 3 or gx.shape != a.shape:
        raise ValueError(f"rglru_scan takes a, gx (B,S,W) of one shape; got "
                         f"{tuple(a.shape)}, {tuple(gx.shape)}")
    if tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 must be (B,W), got {tuple(h0.shape)}")
    if a.dtype not in DTYPE_CODES or gx.dtype != torch.float32 or (
            h0.dtype != torch.float32):
        raise ValueError(f"rglru_scan takes a in float32 or bfloat16 and gx, "
                         f"h0 in float32; got {a.dtype}, {gx.dtype}, "
                         f"{h0.dtype}")
    if gx.device != a.device or h0.device != a.device:
        raise ValueError("a, gx and h0 must be on one device")


@functools.cache
def _library():
    """The built kernel library with its C signature declared."""
    lib = cuda_build.load("rglru_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.rglru_scan_fwd, lib.rglru_scan_fwd_ring):
        fn.argtypes = [p] * 5 + [i] * 4 + [p]
        fn.restype = i
    return lib


def rglru_scan(a: torch.Tensor, gx: torch.Tensor, h0: torch.Tensor) -> tuple:
    """a (B,S,W) float32 or bfloat16; gx (B,S,W) float32; h0 (B,W)
    float32. Returns (h_seq (B,S,W) float32, h_last (B,W) float32)."""
    _check(a, gx, h0)
    if a.device.type == "cpu":
        return rglru_scan_torch(a, gx, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, got "
                         f"{a.device}")
    if needs_grad(a, gx, h0):
        raise RuntimeError("the RG-LRU kernel has no backward and would cut "
                           "the autograd graph; train through RGLRUScanFn")
    B, S, W = a.shape
    a, gx, h0 = a.contiguous(), gx.contiguous(), h0.contiguous()
    path = route(a, gx)
    lib = _library()
    fn = lib.rglru_scan_fwd_ring if path == "ring" else lib.rglru_scan_fwd
    y = torch.empty_like(gx)
    h_last = torch.empty_like(h0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), gx.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), DTYPE_CODES[a.dtype], B, S, W, stream)
    if err:
        raise RuntimeError(f"rglru_scan ({path}) launch failed: error {err}")
    rglru_scan.launches += 1
    rglru_scan.route_launches[path] += 1
    return y, h_last


rglru_scan.launches = 0
rglru_scan.route_launches = dict.fromkeys(sorted(set(ROUTES.values())), 0)


class RGLRUScanFn(torch.autograd.Function):
    """`rglru_scan` under autograd: (a, gx, h0) -> (h_seq, h_last). The
    backward runs the scan itself on the reversed recurrence of the
    gradients: a' = flip(cat(a[:, 1:], 1)), gx' = flip(dy) and h0' =
    dh_last give g = flip(h'), the gradient at each state; then
    `ref.rglru_grads_from_g`. It scans the ``a`` the forward scanned, in
    its dtype, so the gradient is that of the function computed. a' and
    gx' are fresh contiguous tensors, which the ring route can read (a
    slice ``a[:, 1:]`` is not 16-byte aligned). On the CPU the backward
    is the plain loop `ref.rglru_scan_bwd_torch`."""

    @staticmethod
    def forward(ctx, a, gx, h0):
        h_seq, h_last = rglru_scan(a, gx, h0)
        ctx.save_for_backward(a, h_seq, h0)
        return h_seq, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, h_seq, h0 = ctx.saved_tensors
        with cost.COUNTER.count("rglru_scan", lambda: cost.rglru_scan_backward(
                *a.shape, a.element_size())):
            if a.device.type == "cpu":
                return rglru_scan_bwd_torch(a, h_seq, h0, dy, dh_last)
            B, W = h0.shape
            a_rev = torch.cat([a[:, 1:], a.new_ones(B, 1, W)], 1).flip(1)
            g_rev, _ = rglru_scan(a_rev.contiguous(),
                                  dy.float().flip(1).contiguous(),
                                  dh_last.float().contiguous())
            return rglru_grads_from_g(a, h_seq, h0, g_rev.flip(1))


def rglru_gated(x, r, i, lam, *, h0=None) -> tuple:
    """Full RG-LRU with the gates outside the scan, as the reference's
    `rglru_pallas`: x, r, i (B,S,W); lam (W,); h0 (B,W). Returns
    (h_seq (B,S,W) in x.dtype, h_final (B,W) float32). Under grad the
    gates are plain autograd and the scan is `RGLRUScanFn`."""
    B, S, W = x.shape
    a, gx = rglru_gates(x, r, i, lam)
    h0f = (torch.zeros(B, W, device=x.device) if h0 is None
           else h0.float())
    a = a.to(x.dtype)
    scan = RGLRUScanFn.apply if needs_grad(a, gx, h0f) else rglru_scan
    with cost.COUNTER.count("rglru_scan", lambda: cost.rglru_scan(
            B, S, W, a.element_size())):
        y, h_last = scan(a, gx, h0f)
    return y.to(x.dtype), h_last
