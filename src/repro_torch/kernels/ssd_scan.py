"""Mamba-2 SSD chunked scan: the CUDA kernel and its plain PyTorch version.

`ssd_scan` replaces the Pallas TPU kernel `ssd_pallas`
(`src/repro/kernels/ssd_scan.py:67`), with its contract: one group of B
and C (G = 1) and a zero initial state. On a CUDA tensor it runs the
hand-written sm_90a kernel in ``csrc/ssd_scan.cu`` (three launches: chunk
states, the carry over chunks, the outputs; see the source for the
design and its bound) or raises. `ROUTES` names the kernel for each
dtype: ``"mma_sync"`` (bf16, tensor cores, the f32 intermediates split
into bf16 hi + lo) or ``"cuda_core"`` (float32 arithmetic). x, b and c
go to the kernel uncopied, through their strides (the model passes
strided views of its conv output). On a CPU tensor it runs
`ssd_scan_torch`, the plain version, which is also what the kernel is
held against on the card.

Training goes through `SSDScanFn`, whose forward is `ssd_scan` and whose
backward recomputes `ssd_chunked` (float32 inside) under autograd
(`ref.ssd_chunked_bwd_torch`): the reference has no backward kernel and
differentiates that plain function. The raw `ssd_scan` raises on the
card when autograd would need a backward (grad enabled and an input
requiring grad) rather than return outputs cut from the graph.

`ssd_scan.launches` counts calls that launched the kernel and
`ssd_scan.route_launches` those calls per route; CPU calls do not
count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import cuda_build
from repro_torch.kernels.ref import (needs_grad, ssd_chunked,
                                    ssd_chunked_bwd_torch)

HEAD_DIMS = (16, 32, 64)                # templates in the CUDA source
MAX_CHUNK = 256                         # the kernel's block scan
ROUTES = {torch.float32: "cuda_core", torch.bfloat16: "mma_sync"}


def ssd_scan_torch(x, dt, a_log, b, c, d, *, chunk: int = 128):
    """Plain PyTorch version of `ssd_scan`: the chunked form that the
    Pallas kernel mirrors, from a zero state."""
    return ssd_chunked(x, dt, a_log, b, c, d, chunk=chunk)


def _check(x, dt, a_log, b, c, d, Q):
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError("ssd_scan takes x (B,S,H,P) and b, c (B,S,1,N)")
    B, S, H, P = x.shape
    if b.shape[:2] != (B, S) or b.shape[2] != 1:
        raise ValueError(f"b and c must be (B,S,1,N) with one group, got "
                         f"{tuple(b.shape)} for x {tuple(x.shape)}")
    if tuple(dt.shape) != (B, S, H) or a_log.shape != (H,) or d.shape != (H,):
        raise ValueError(f"dt must be (B,S,H) and a_log, d (H,); got "
                         f"{tuple(dt.shape)}, {tuple(a_log.shape)}, "
                         f"{tuple(d.shape)}")
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    if x.dtype not in ROUTES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssd_scan takes x, b, c in one of float32 or "
                         f"bfloat16; got {x.dtype}, {b.dtype}, {c.dtype}")
    if any(t.device != x.device for t in (dt, a_log, b, c, d)):
        raise ValueError("all inputs must be on one device")


@functools.cache
def _library():
    """The built kernel library with its C signatures declared."""
    lib = cuda_build.load("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ssd_scan_fwd, lib.ssd_scan_fwd_mma):
        fn.argtypes = [p] * 10 + [i] * 6 + [ctypes.c_longlong] * 7 + [p]
        fn.restype = i
    return lib


def _strides(x, b, c, path):
    """The element strides the kernel reads x, b and c through; raises on
    a layout the route cannot read."""
    if x.stride(3) != 1 or b.stride(3) != 1 or c.stride(3) != 1:
        raise ValueError("ssd_scan needs x, b and c with a unit inner stride")
    strides = (x.stride(0), x.stride(1), x.stride(2), b.stride(0),
               b.stride(1), c.stride(0), c.stride(1))
    if path == "mma_sync":
        N = b.shape[3]
        if N % 16 or any(s % 8 for s in strides) or any(
                t.data_ptr() % 16 for t in (x, b, c)):
            raise ValueError(
                "the mma_sync kernel needs N a multiple of 16 and x, b, c "
                "rows 16-byte aligned (pointers 16-byte aligned, strides "
                f"multiples of 8 elements); got N={N}, strides {strides}")
    return strides


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
             chunk: int = 128) -> tuple:
    """x (B,S,H,P); dt (B,S,H); a_log, d (H,); b, c (B,S,1,N).

    Returns (y (B,S,H,P) in x.dtype, h_final (B,H,P,N) float32): the SSD
    scan from a zero state with chunks of min(chunk, S) steps. On the
    card: P in {16, 32, 64}, chunk <= 256, and N small enough that the
    output launch's tiles fit a block's 232,448 B (227 KiB) of shared
    memory. At P 64 and N 128 the float32 route's `ssd_out` takes
    101,152 B at any chunk (N up to 384 fits); the bfloat16 route's
    `ssd_out_mma` takes 104,448 B at chunk 64 and 205,824 B at chunk
    256 (N up to 272 fits there). A shape that does not fit fails in
    ``cudaFuncSetAttribute``, and the wrapper raises.
    """
    Q = min(chunk, x.shape[1])
    _check(x, dt, a_log, b, c, d, Q)
    if x.device.type == "cpu":
        return ssd_scan_torch(x, dt, a_log, b, c, d, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, got "
                         f"{x.device}")
    if needs_grad(x, dt, a_log, b, c, d):
        raise RuntimeError("the SSD kernel has no backward and would cut the "
                           "autograd graph; train through SSDScanFn")
    B, S, H, P = x.shape
    N = b.shape[3]
    if P not in HEAD_DIMS or Q > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes P in {HEAD_DIMS} and chunks "
                         f"of at most {MAX_CHUNK}; got P={P}, chunk={Q}")
    path = ROUTES[x.dtype]
    strides = _strides(x, b, c, path)
    lib = _library()
    dt = dt.float().contiguous()
    a_log, d = a_log.float().contiguous(), d.float().contiguous()
    nc = S // Q
    y = torch.empty(B, S, H, P, dtype=x.dtype, device=x.device)
    h_final = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    states = torch.empty(B, nc, H, P, N, dtype=torch.float32, device=x.device)
    cum_end = torch.empty(B, nc, H, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = lib.ssd_scan_fwd_mma if path == "mma_sync" else lib.ssd_scan_fwd
        err = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                 c.data_ptr(), d.data_ptr(), y.data_ptr(), h_final.data_ptr(),
                 states.data_ptr(), cum_end.data_ptr(), B, S, H, P, N, Q,
                 *strides, stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed ({path}): error {err}")
    ssd_scan.launches += 1
    ssd_scan.route_launches[path] += 1
    return y, h_final


ssd_scan.launches = 0
ssd_scan.route_launches = dict.fromkeys(sorted(ROUTES.values()), 0)


class SSDScanFn(torch.autograd.Function):
    """`ssd_scan` under autograd: (x, dt, a_log, b, c, d, chunk) -> (y,
    h_final). The forward saves the inputs as they came (the mixer's
    strided views stay views); the backward is
    `ref.ssd_chunked_bwd_torch` at the same chunk, with a missing
    gradient of y or h_final taken as zero."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_log, b, c, d)
        ctx.chunk = chunk
        return ssd_scan(x, dt, a_log, b, c, d, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dh_final):
        saved = ctx.saved_tensors       # unpacked once (checkpoint allows one)
        if dy is None:
            dy = torch.zeros_like(saved[0])
        return (*ssd_chunked_bwd_torch(*saved, dy, dh_final,
                                       chunk=ctx.chunk), None)
