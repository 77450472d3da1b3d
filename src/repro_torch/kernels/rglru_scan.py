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

`rglru_scan.launches` counts kernel launches and
`rglru_scan.route_launches` those launches per route; CPU calls do not
count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import cuda_build
from repro_torch.kernels.ref import rglru_gates

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


def rglru_gated(x, r, i, lam, *, h0=None) -> tuple:
    """Full RG-LRU with the gates outside the scan, as the reference's
    `rglru_pallas`: x, r, i (B,S,W); lam (W,); h0 (B,W). Returns
    (h_seq (B,S,W) in x.dtype, h_final (B,W) float32)."""
    B, S, W = x.shape
    a, gx = rglru_gates(x, r, i, lam)
    h0f = (torch.zeros(B, W, device=x.device) if h0 is None
           else h0.float())
    y, h_last = rglru_scan(a.to(x.dtype), gx, h0f)
    return y.to(x.dtype), h_last
