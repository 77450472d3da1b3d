"""The work of each kernel call, from its shapes and dtypes, and the
counter that adds it up.

Each function returns ``(flops, bytes)`` for one call: the operations
the algorithm needs and the bytes it must move, each input read once
and each output written once. These are the numbers a roofline divides
by the card's peaks (`repro_torch.launch.dryrun_lib.HW`), and the ones
``chip_smoke.py`` prints its ``bound_ms`` from:

  - `admission_rounds`: the capacity-admission rounds of one planner
    epoch (no arithmetic to speak of: bytes only);
  - `flash_attention`: GQA attention, without and with the row
    log-sum-exp, over the (q, key) pairs its causal and window masks
    keep;
  - `ssd_scan`: the Mamba-2 chunked SSD scan (G = 1, zero h0);
  - `rglru_scan` and `rglru_scan_backward`: the RG-LRU recurrence and
    its time-reversed backward;
  - `attention_backward` and `ssd_backward`: the two backwards that
    training runs after those kernels (attention's on the bf16 backward
    kernel or its plain float32 version, the SSD's in plain torch).

`COUNTER` adds the cost of every call that the card serves with a hand
kernel: `ops.mha`, `ops.ssd` and `ops.rglru` (and the RG-LRU backward)
and `admission_rounds` count it on every route, the kernel on the card
and the plain version on the CPU, so a roofline reads the same work
whatever implements it. The attention backward's kernel
(`flash_attention_backward`) counts as ``flash_attention_bwd``; its
plain version is aten ops, which a probe counts as such. It counts only inside ``with COUNTER.on():``
(which `repro_torch.launch.dryrun_lib.count_cost` enters); elsewhere a
call pays for one attribute read and computes no cost. The kernels
launch outside aten, where no ``TorchDispatchMode`` sees them; while a
counted call runs, ``COUNTER.depth`` is above 0, and a probe that counts
aten ops (`repro_torch.launch.dryrun_lib`) leaves out the plain
version's ops there, so that the formula stands in for them on both
routes. This is the counterpart of what XLA's ``cost_analysis()``
reports for a Pallas call.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np

KERNELS = ("admission_round", "flash_attention", "flash_attention_bwd",
           "ssd_scan", "rglru_scan")

# of `attention_backward`'s 10 FLOPs a kept pair per Dh, the 8 of the dV,
# dP, dQ and dK products: a backward's bound counts these and leaves out
# the recomputed scores (2), which a backward that kept P would not need
ATTENTION_BACKWARD_BOUND_SHARE = 8 / 10


def admission_rounds(N: int, R: int, rounds: int) -> tuple:
    """One call of `admission_rounds`: reads net (N, R) f64, assign,
    dst, struck (N,) int32, eligible (N,) bool and remaining (R,) int32;
    writes dst', struck' (N,) int32 and want (rounds, R) int32."""
    nbytes = (N * R * 8 + N * (4 + 1 + 4 + 4) + R * 4) + (N * 8
                                                          + rounds * R * 4)
    return 0, nbytes


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(q, key) pairs that attention keeps, q and key positions both from
    0: key j <= row i if causal, j > i - window if ``window > 0``."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window and window > 0 else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def _attention_io(B, Sq, Skv, Hq, Hkv, Dh, itemsize) -> int:
    """q and out (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh)."""
    return itemsize * (2 * B * Sq * Hq * Dh + 2 * B * Skv * Hkv * Dh)


def flash_attention(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, Dh: int,
                    itemsize: int, causal: bool, window: int,
                    lse: bool = False) -> tuple:
    """One forward: the score and value products over the kept pairs;
    reads q, k, v and writes out (and the float32 lse, (B, Hq, Sq))."""
    flops = 4 * B * Hq * Dh * attention_pairs(Sq, Skv, causal, window)
    nbytes = _attention_io(B, Sq, Skv, Hq, Hkv, Dh, itemsize)
    if lse:
        nbytes += 4 * B * Hq * Sq
    return flops, nbytes


def attention_backward(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, Dh: int,
                       itemsize: int, causal: bool, window: int) -> tuple:
    """One recomputing backward of `FlashAttentionFn`, whichever
    computes it (the bf16 kernel of `flash_attention_backward` or its
    plain version `ref.flash_bwd_torch`): the s, dv, dp, dq and dk
    products over the kept pairs; bytes: q, k, v, out, dout and lse."""
    flops = 10 * B * Hq * Dh * attention_pairs(Sq, Skv, causal, window)
    nbytes = (_attention_io(B, Sq, Skv, Hq, Hkv, Dh, itemsize)
              + itemsize * B * Sq * Hq * Dh + 4 * B * Hq * Sq)
    return flops, nbytes


def _ssd_products(B, S, H, P, N, Q) -> int:
    """The chunked form's products: C·Bᵀ per chunk (shared by the
    heads), then per head the full Q × Q product with x, the chunk
    state and the entering state's contribution."""
    return B * (S // Q) * (2 * Q * Q * N + H * (2 * Q * Q * P + 4 * Q * P * N))


def ssd_scan(B: int, S: int, H: int, P: int, N: int, chunk: int,
             itemsize: int) -> tuple:
    """One call: x, b, c read and y written in the input dtype; dt,
    a_log, d read and h_final written in float32."""
    Q = min(chunk, S)
    nbytes = (itemsize * (2 * B * S * H * P + 2 * B * S * N)
              + 4 * (B * S * H + 2 * H + B * H * P * N))
    return _ssd_products(B, S, H, P, N, Q), nbytes


def ssd_backward(B: int, S: int, H: int, P: int, N: int, chunk: int,
                 itemsize: int) -> tuple:
    """The plain backward (`ref.ssd_chunked_bwd_torch`): the recompute
    and the autodiff, 3 × the forward's products; x, b, c and dy read
    and their gradients written in the input dtype, dt read and its
    gradient written in float32."""
    Q = min(chunk, S)
    nbytes = (itemsize * (2 * B * S * H * P + 4 * B * S * N)
              + 2 * 4 * B * S * H)
    return 3 * _ssd_products(B, S, H, P, N, Q), nbytes


def rglru_scan(B: int, S: int, W: int, a_itemsize: int) -> tuple:
    """One forward: a (in its dtype) and gx read, h_seq written in
    float32, h0 and h_last (B, W) float32; a product and a sum a step."""
    return 2 * B * S * W, B * S * W * (a_itemsize + 4 + 4) + 2 * 4 * B * W


def rglru_scan_backward(B: int, S: int, W: int, a_itemsize: int) -> tuple:
    """One backward: a, h_seq and dy read, da (a's dtype) and dgx
    written; h0, dh_last and dh0 (B, W) float32; 3 operations a step."""
    nbytes = B * S * W * (a_itemsize + 4 + 4 + a_itemsize + 4) + 3 * 4 * B * W
    return 3 * B * S * W, nbytes


class CostCounter:
    """Calls, FLOPs and bytes of the hand kernels' work, by kernel.

    `count(name, work)` is a context manager around one call, ``work`` a
    callable returning the call's ``(flops, bytes)``; it counts while
    `on()` is entered and is a no-op otherwise. A call inside another's
    counts once (the outer). With `aten_flops` set (a callable returning
    a running aten FLOP total), the FLOPs that total gains inside counted
    calls add up in `excluded_flops`."""

    def __init__(self):
        self.enabled = False
        self.aten_flops: Optional[Callable[[], int]] = None
        self.reset()

    def reset(self):
        self.calls = dict.fromkeys(KERNELS, 0)
        self.flops = dict.fromkeys(KERNELS, 0)
        self.bytes = dict.fromkeys(KERNELS, 0)
        self.excluded_flops = 0
        self.depth = 0

    @contextlib.contextmanager
    def on(self):
        """Count the calls made inside this block."""
        before, self.enabled = self.enabled, True
        try:
            yield self
        finally:
            self.enabled = before

    def count(self, name: str, work: Callable[[], tuple]):
        if not self.enabled:
            return _NOT_COUNTING
        return self._count(name, *work())

    @contextlib.contextmanager
    def _count(self, name: str, flops: int, nbytes: int):
        outer = self.depth == 0
        if outer:
            self.calls[name] += 1
            self.flops[name] += int(flops)
            self.bytes[name] += int(nbytes)
        start = self.aten_flops() if outer and self.aten_flops else 0
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1
            if outer and self.aten_flops:
                self.excluded_flops += self.aten_flops() - start


_NOT_COUNTING = contextlib.nullcontext()
COUNTER = CostCounter()
