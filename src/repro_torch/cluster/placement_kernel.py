"""Capacity-admission preference round: the CUDA kernel and its plain
PyTorch version.

One round of the planner's capacity admission (see
`repro_torch.cluster.placement`): every eligible, unplaced container
takes its best un-struck region (strict ``>``, so the first maximum);
it wants that region if the net saving is positive and the region is not
its current one; the first ``remaining[r]`` wanters of each region, in
container-index order, are admitted; each denied choice is struck into
an int32 bitmask.

`admission_rounds` runs all the rounds of one planner epoch, with the
planner's update of the free slots between them, and replaces the Pallas
TPU kernel `admission_round` (`src/repro/cluster/placement_pallas.py:120`),
which the reference calls once per round. On a CUDA tensor it launches
the hand-written sm_90a kernel in ``csrc/admission_round.cu`` (one
cooperative launch per call, one grid barrier per round; see the source
for the design and its bound) or raises. On a CPU tensor it runs
`admission_rounds_torch`, the plain version: `admission_round_torch`,
ported from the reference's `_admission_round_xla`
(`src/repro/cluster/placement_jax.py:90`) with a ``cumsum`` rank, once
per round. The plain version is also what the kernel is held against on
the card. `admission_round` is the Pallas kernel's one-round contract,
through the same kernel.

`admission_rounds.launches` counts kernel launches (one per CUDA call);
CPU calls do not count. Inside ``repro_torch.kernels.cost.COUNTER.on()``
every call with N > 0 adds its work to that counter, on both routes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import cuda_build
from repro_torch.kernels import cost

MAX_REGIONS = 31        # the strike bitmask is an int32


def _prefer(net, struck):
    """Best un-struck region per row and its net, strict ``>`` over the
    regions in order (first maximum wins)."""
    R = net.shape[1]
    neg = float("-inf")
    best = torch.zeros(net.shape[0], dtype=torch.int32, device=net.device)
    net_best = torch.where((struck & 1) > 0, neg, net[:, 0])
    for r in range(1, R):
        v = torch.where(((struck >> r) & 1) > 0, neg, net[:, r])
        m = v > net_best
        best = torch.where(m, r, best)
        net_best = torch.where(m, v, net_best)
    return best, net_best


def admission_round_torch(net, assign, eligible, dst, struck, remaining):
    """Plain PyTorch version of one admission round; same contract as
    `admission_round`. Returns ``(dst', struck', want_total)``."""
    R = net.shape[1]
    best, net_best = _prefer(net, struck)
    want = eligible & (dst < 0) & (net_best > 0.0) & (best != assign)
    cols = torch.arange(R, dtype=torch.int32, device=net.device)
    onehot = want[:, None] & (best[:, None] == cols[None, :])
    rank = torch.cumsum(onehot.to(torch.int32), dim=0)
    admitted = (onehot & (rank <= remaining[None, :])).any(dim=1)
    dst_out = torch.where(admitted, best, dst)
    denied = want & ~admitted
    struck_out = torch.where(denied, struck | (1 << best), struck)
    want_total = onehot.sum(dim=0, dtype=torch.int32)
    return dst_out, struck_out, want_total


def _check(net, assign, eligible, dst, struck, remaining):
    if net.dim() != 2:
        raise ValueError(f"net must be (N, R), got shape {tuple(net.shape)}")
    N, R = net.shape
    if not 1 <= R <= MAX_REGIONS:
        raise ValueError(f"admission needs 1 <= R <= {MAX_REGIONS} regions, "
                         f"got {R}")
    want = {"net": (net, torch.float64, (N, R)),
            "assign": (assign, torch.int32, (N,)),
            "eligible": (eligible, torch.bool, (N,)),
            "dst": (dst, torch.int32, (N,)),
            "struck": (struck, torch.int32, (N,)),
            "remaining": (remaining, torch.int32, (R,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} of shape {shape}, "
                             f"got {t.dtype} of shape {tuple(t.shape)}")
        if t.device != net.device:
            raise ValueError(f"{name} is on {t.device}, net on {net.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _library():
    """The built kernel library with its C signatures declared."""
    lib = cuda_build.load("admission_round")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.admission_rounds_plan.argtypes = [i, p]
    lib.admission_rounds_plan.restype = i
    lib.admission_rounds.argtypes = [p] * 6 + [i] * 5 + [p] * 6
    lib.admission_rounds.restype = i
    return lib


def admission_rounds_torch(net, assign, eligible, dst, struck, remaining,
                           rounds):
    """Plain PyTorch version of `admission_rounds`: `rounds` calls of
    `admission_round_torch`, each followed by the planner's update
    ``remaining -= min(want_total, remaining)``."""
    wants = []
    for _ in range(rounds):
        dst, struck, want = admission_round_torch(net, assign, eligible, dst,
                                                  struck, remaining)
        remaining = remaining - torch.minimum(want, remaining)
        wants.append(want)
    return dst, struck, torch.stack(wants)


def admission_rounds(net, assign, eligible, dst, struck, remaining, rounds):
    """The ``rounds`` capacity-admission preference rounds of one epoch.

    ``net`` (N, R) f64 epoch net savings; ``assign`` (N,) int32 current
    regions; ``eligible`` (N,) bool dwell gate; ``dst`` (N,) int32 round
    carry (-1 = unplaced); ``struck`` (N,) int32 denied-region bitmask;
    ``remaining`` (R,) int32 free slots at the first round's start. All
    contiguous, on one device. Between rounds ``remaining -=
    min(want_total, remaining)``. Returns ``(dst', struck', want)``: two
    (N,) int32 vectors after the last round and the (rounds, R) int32
    count of wanters per region in each round. On a CUDA tensor one call
    is one launch of the kernel.
    """
    _check(net, assign, eligible, dst, struck, remaining)
    if rounds < 1:
        raise ValueError(f"admission_rounds needs rounds >= 1, got {rounds}")
    if net.device.type not in ("cpu", "cuda"):
        raise ValueError(f"admission_rounds runs on cuda or cpu tensors, "
                         f"got {net.device}")
    N, R = net.shape
    if N == 0:                          # nothing to admit: no launch, no count
        return (dst.clone(), struck.clone(),
                torch.zeros((rounds, R), dtype=torch.int32, device=net.device))
    with cost.COUNTER.count("admission_round",
                            lambda: cost.admission_rounds(N, R, rounds)):
        if net.device.type == "cpu":
            return admission_rounds_torch(net, assign, eligible, dst, struck,
                                          remaining, rounds)
        lib = _library()
        dev = net.device
        i32 = dict(dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            blocks = ctypes.c_int(0)
            variant = lib.admission_rounds_plan(N, ctypes.byref(blocks))
            if variant < 0:
                raise RuntimeError(f"admission_rounds_plan failed: CUDA "
                                   f"error {-variant}")
            dst_out = torch.empty_like(dst)
            struck_out = torch.empty_like(struck)
            want = torch.empty((rounds, R), **i32)
            counts = torch.empty((rounds, blocks.value, R), **i32)
            pref = torch.empty(N, **i32)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.admission_rounds(
                net.data_ptr(), assign.data_ptr(), eligible.data_ptr(),
                dst.data_ptr(), struck.data_ptr(), remaining.data_ptr(), N,
                R, rounds, variant, blocks.value, counts.data_ptr(),
                dst_out.data_ptr(), struck_out.data_ptr(), pref.data_ptr(),
                want.data_ptr(), stream)
        if err:
            raise RuntimeError(f"admission_rounds cooperative launch failed: "
                               f"CUDA error {err}")
    admission_rounds.launches += 1
    return dst_out, struck_out, want


admission_rounds.launches = 0


def admission_round(net, assign, eligible, dst, struck, remaining):
    """One capacity-admission preference round: the one-round contract of
    the Pallas kernel, `admission_rounds` with ``rounds=1`` (one launch,
    counted by `admission_rounds.launches`). Returns ``(dst', struck',
    want_total)``; ``want_total`` (R,) int32 closes the caller's counters
    (admitted = min(want_total, remaining))."""
    dst, struck, want = admission_rounds(net, assign, eligible, dst, struck,
                                         remaining, 1)
    return dst, struck, want[0]
