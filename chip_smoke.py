#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the repository root; needs one CUDA card and nvcc. Phases, each
raising on failure so the run exits non-zero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
     TF32 off for float32 matmuls (the card-vs-CPU checks depend on it);
  2. build every kernel of the port from ``src/repro_torch/csrc``, one
     nvcc per source, all started together; count the tensor-core and
     TMA instructions (HGMMA, HMMA, UTMALDG, UBLKCP) of each kernel
     function with ``cuobjdump -sass`` and fail if the wgmma flash
     kernel or the mma.sync SSD kernels have no tensor-core instruction,
     or the RG-LRU ring kernel no TMA or bulk copy;
  3. kernel phase: each kernel against its plain PyTorch version on the
     card, on the same random inputs, at the main paths' shapes and
     tests/test_kernels.py's cases: the admission rounds of an epoch
     exactly (R rounds in one call, at the planner's N = 100,000, at
     R = 5 and at an N beyond one wave of blocks), timed per epoch
     call and per one-round call; flash
     attention within 2e-5 in float32 and 2e-2 in bfloat16, Dh 256 at
     16:1 heads with a window that bites included, and bf16 cases across
     the wgmma route's tile edges; the SSD scan within 5e-3 / 1e-1 (y)
     and 5e-3 (h_final), with a case whose masked triangle overflows,
     tile-edge cases and x, b, c as the mixer's strided views; the
     RG-LRU scan bit-equal on its ring route and within 1e-5 / 3e-2 (y)
     and 1e-4 / 1e-2 (h) on its column route. Each case
     records its route and its margin (the share of the allclose bar its
     worst element uses). Each kernel is timed with CUDA events at its
     main path's shape, beside one PyTorch library call where one
     computes the same function, and the least time the card could take
     (`bound_ms`);
  3b. bf16 through real layers: phi4-mini and mamba2 at their published
     widths, 2 layers, prefill logits with the kernels against the plain
     versions (``attn_impl``/``ssm_impl`` "ref"), within 2e-2 of the max
     |logit|;
  4. sweep cross-check: the placed sweep at 5,000 traces x 10 targets x
     288 epochs on the card and on the CPU: rows within 1e-9, plans equal;
  5. sweep at full width: the placed sweep of
     `benchmarks/figs.py::jax_sweep_scale` without its traffic, energy,
     elasticity and fault layers: 100,000 Azure-like traces x 10 targets
     (N = 1,000,000 containers), 288 five-minute epochs, regions
     PL/NL/CAISO at capacity 60,000 each, CarbonContainerPolicy("energy"),
     through `SweepSpec(...).run()`;
  6. serving cross-checks at the published widths in float32, the same
     weights on the card and on the CPU, batch 2, then 8 decode steps fed
     the CPU's greedy tokens, every step's logits within 1e-3:
     phi4-mini-3.8b at 2 layers (128-token prompts), mamba2-2.7b at 2
     layers (256), recurrentgemma-9b at 4 layers, one superlayer and one
     trailing recurrent block (256; its window cut to 128, so that it
     bites in the prefill and the ring wraps in decode);
  7. serving at full width, one engine at a time: phi4-mini-3.8b,
     mamba2-2.7b and recurrentgemma-9b with seeded random weights on the
     card, `ServeEngine.generate` of 32 greedy tokens after 4 prompts of
     2,048 random tokens, then a torch.profiler breakdown of one prefill
     and of one decode step.

Phases 5 and 7 are the main paths: every kernel's launch counter is set
to 0 just before each path and read just after; each path must have
launched exactly its kernels (T admission launches in the sweep, one
per epoch; per prefill 32 flash launches for phi4-mini, 64 SSD launches
for Mamba-2, 26 RG-LRU and 12 flash launches for RecurrentGemma) and no
others, every flash launch on the wgmma route, every SSD launch on the
mma_sync route and every RG-LRU launch on the ring route.

Prints the nvidia-smi line, one line of phase results, the ``kernels``
JSON line, and last ``{"ok": true, "device": {...}}``. The full record
goes to ``chiprun_out/chip_smoke.json``.
"""
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
SEED = 2
REGIONS = ("PL", "NL", "CAISO")
N_TARGETS = 10
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW_TOKENS = 4, 2048, 32
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores, same
FP32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TIMED_REPS = 50


def _median_ms(fn, reps=TIMED_REPS, warmup=5, head_start_cycles=0):
    """Median time of one call between two CUDA events. With a head
    start the stream first runs a spin kernel long enough for the host
    to enqueue the whole call behind it, so the events time the call's
    device work alone, without the host's launch overhead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if head_start_cycles:
            torch.cuda._sleep(head_start_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_profile(fn):
    """Run `fn` under torch.profiler; returns (wall_s, device_s, top)
    with device_s the summed time of the CUDA kernels it ran and top the
    kernels by device time. device_s is None when the profiler saw no
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.self_device_time_total, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(reverse=True)
    dev_s = sum(k[0] for k in kernels) / 1e6 if kernels else None
    top = [{"name": k[2][:120], "device_s": k[0] / 1e6, "count": k[1]}
           for k in kernels[:12]]
    return wall, dev_s, top


def _margin(got, want, tol):
    """max |got - want| / (tol + tol |want|): the share of the allclose bar
    (atol = rtol = tol) that the worst element uses; below 1 passes."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def _admission_inputs(N, R, seed, dev):
    """Random contended round: nets rounded to quarters (ties), random
    strike masks, a fifth already placed, few free slots."""
    rng = np.random.default_rng(seed)
    i32 = dict(dtype=torch.int32, device=dev)
    net = torch.as_tensor(np.round(rng.normal(0.0, 1.0, (N, R)) * 4) / 4,
                          dtype=torch.float64, device=dev)
    assign = torch.as_tensor(rng.integers(0, R, N), **i32)
    elig = torch.as_tensor(rng.random(N) < 0.8, device=dev)
    dst = torch.as_tensor(np.where(rng.random(N) < 0.2,
                                   rng.integers(0, R, N), -1), **i32)
    struck = torch.as_tensor(rng.integers(0, 1 << R, N) & rng.integers(
        0, 1 << R, N), **i32)
    remaining = torch.as_tensor(rng.integers(0, max(2, N // (8 * R)), R),
                                **i32)
    return net, assign, elig, dst, struck, remaining


def _kernel_record(name, source, replaces, kernel, plain, library, *,
                   nbytes, flops, peak_flops, checked, max_abs_err,
                   tolerance, kernel_head_start, plain_head_start,
                   plain_reps=TIMED_REPS):
    """One kernel's record, the same keys for every kernel: its time and
    its plain version's (CUDA events, median; with a head start so the
    device work alone is timed, and as one call from the host), one
    library call's time where `library` is given, and the bound: the
    larger of the bytes that must move (each input read once, each output
    written once) over HBM bandwidth and the operations over the peak
    rate for their type."""
    ms = _median_ms(kernel, head_start_cycles=kernel_head_start)
    plain_ms = _median_ms(plain, reps=plain_reps,
                          head_start_cycles=plain_head_start)
    library_ms = (_median_ms(library, head_start_cycles=kernel_head_start)
                  if library is not None else None)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / peak_flops * 1e3 if flops else 0.0
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": max_abs_err, "tolerance": tolerance,
            "checked": checked, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "call_ms": _median_ms(kernel),
            "plain_call_ms": _median_ms(plain, reps=plain_reps),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "operations" if op_ms > byte_ms else "bytes",
            "bytes": nbytes, "flops": flops}


# N, R, seed of the admission checks: the planner's size, five regions,
# and an N that needs more 1,024-container tiles than the card holds
# blocks at once
ADMISSION_CASES = [(100_000, 3, 0), (12_345, 5, 1), (400_000, 3, 2)]


def admission_phase(dev):
    from repro_torch.cluster.placement_kernel import (admission_round,
                                                      admission_round_torch,
                                                      admission_rounds,
                                                      admission_rounds_torch)
    checked = []
    for N, R, seed in ADMISSION_CASES:
        args = _admission_inputs(N, R, seed, dev)
        got = admission_rounds(*args, R)
        want = admission_rounds_torch(*args, R)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in
                  zip(got, want))
        if err != 0:
            raise AssertionError(f"admission_rounds differs from its plain "
                                 f"version at N={N}, R={R}: max abs {err}")
        remaining, contended = args[5], 0
        for w in want[2]:
            contended += int((w > remaining).any())
            remaining = remaining - torch.minimum(w, remaining)
        if not contended:
            raise AssertionError(f"kernel inputs at N={N}, R={R} are not "
                                 f"contended")
        checked.append({"N": N, "R": R, "rounds": R, "max_abs_err": err,
                        "contended_rounds": contended})
    # time at the main path's shape: one epoch of the planner, N = 100k,
    # R = 3 rounds in one call
    args = _admission_inputs(100_000, 3, 0, dev)
    N, R = args[0].shape
    # each input read once, each output written once
    # (dst' and struck'; want is (rounds, R) with rounds = R)
    nbytes = (N * R * 8 + N * (4 + 1 + 4 + 4) + R * 4) + (N * 8 + R * R * 4)
    record = _kernel_record(
        "admission_round", "src/repro_torch/csrc/admission_round.cu",
        "src/repro/cluster/placement_pallas.py:120",
        lambda: admission_rounds(*args, R),
        lambda: admission_rounds_torch(*args, R),
        None, nbytes=nbytes, flops=0, peak_flops=None, checked=checked,
        max_abs_err=0, tolerance="exact", kernel_head_start=2_000_000,
        plain_head_start=20_000_000)
    # the latency floor: one launch (a one-element fill) and each round's
    # grid barrier, read as the time a round adds to a one-round call
    one = torch.zeros(1, device=dev)
    record["round_ms"] = _median_ms(lambda: admission_round(*args),
                                    head_start_cycles=2_000_000)
    record["launch_ms"] = _median_ms(lambda: one.fill_(1.0),
                                     head_start_cycles=2_000_000)
    record["added_round_ms"] = (record["ms"] - record["round_ms"]) / (R - 1)
    record["plain_round_ms"] = _median_ms(
        lambda: admission_round_torch(*args), head_start_cycles=20_000_000)
    record["shape"] = {"N": N, "R": R, "rounds": R}
    record["library"] = "none: no single PyTorch call computes it"
    return record


# B, Sq, Skv, Hq, Hkv, Dh, causal, window: tests/test_kernels.py's
# ATTN_CASES, SmolLM-135M's prefill shape, a Dh-256 16:1 case where the
# window bites (RecurrentGemma's heads), then cases that cross the wgmma
# kernel's 64-key tiles and 128-row blocks (Sq, Skv not multiples of 64,
# Sq != Skv, a window ending inside a tile, G = 3 and 16, Dh 64 / 128 /
# 256); the main paths' shapes come last
FLASH_CASES = [(2, 128, 128, 4, 2, 32, True, 0),
               (1, 64, 64, 2, 1, 16, True, 24),
               (2, 128, 128, 4, 4, 64, False, 0),
               (1, 96, 96, 8, 2, 32, True, 0),
               (2, 512, 512, 9, 3, 64, True, 0),
               (1, 1024, 1024, 16, 1, 256, True, 512),
               (2, 200, 200, 6, 2, 64, True, 0),
               (1, 1000, 1000, 16, 1, 128, True, 0),
               (1, 1024, 1024, 4, 4, 256, True, 300),
               (1, 200, 1000, 6, 2, 128, False, 0),
               (1, 1000, 200, 3, 1, 64, True, 0),
               (2, 1000, 1000, 8, 8, 256, False, 300)]
FLASH_MAIN = (4, 2048, 2048, 24, 8, 128, True, 0)   # phi4-mini prefill, bf16
FLASH_RG = (4, 2048, 2048, 16, 1, 256, True, 2048)  # RecurrentGemma prefill
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(case, dtype, dev, seed):
    """q, k, v of a case (B, Sq, Skv, Hq, Hkv, Dh, causal, window)."""
    B, Sq, Skv, Hq, Hkv, Dh = case[:6]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(B, S, h, Dh, generator=gen, device=dev).to(dtype)
                 for S, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))


def flash_phase(dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch,
                                                     route)
    checked = []
    runs = [(c, dt) for c in FLASH_CASES for dt in FLASH_TOL]
    runs += [(FLASH_MAIN, torch.bfloat16), (FLASH_RG, torch.bfloat16)]
    for i, (case, dtype) in enumerate(runs):
        causal, window = case[-2], case[-1]
        q, k, v = _qkv(case, dtype, dev, seed=i)
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_torch(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dtype]
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention differs from its plain "
                                 f"version at {case} {dtype}: max abs {err}")
        checked.append({"case": list(case), "dtype": str(dtype)[6:],
                        "route": route(dtype, q.shape[3]),
                        "max_abs_err": err, "tol": tol,
                        "margin": _margin(got, want, tol)})

    def timed(case, seed):
        B, S, _, Hq, Hkv, Dh, causal, window = case
        q, k, v = _qkv(case, torch.bfloat16, dev, seed=seed)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if 0 < window < S:
            raise ValueError("the library yardstick is causal attention "
                             "without a window that bites")
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True).transpose(1, 2)
        library_err = float((sdpa.float() - flash_attention_torch(
            q, k, v).float()).abs().max())
        pairs = S * (S + 1) // 2                   # causal (q, kv) pairs
        record = _kernel_record(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:78",
            lambda: flash_attention(q, k, v, causal=causal, window=window),
            lambda: flash_attention_torch(q, k, v, causal=causal,
                                          window=window),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True),
            nbytes=2 * (2 * B * S * Hq * Dh + 2 * B * S * Hkv * Dh),
            flops=4 * B * Hq * Dh * pairs, peak_flops=BF16_FLOP_PER_S,
            checked=checked,
            max_abs_err=max(c["max_abs_err"] for c in checked),
            tolerance="2e-5 float32, 2e-2 bfloat16 (abs and rel)",
            kernel_head_start=2_000_000, plain_head_start=20_000_000)
        record["shape"] = {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "Dh": Dh,
                           "dtype": "bfloat16", "causal": causal,
                           "window": window}
        record["library"] = ("torch.nn.functional."
                             "scaled_dot_product_attention(is_causal=True, "
                             "enable_gqa=True)")
        record["library_max_abs_err"] = library_err
        record["kernel_route"] = route(torch.bfloat16, Dh)
        record["max_margin"] = max(c["margin"] for c in checked)
        return record

    record = timed(FLASH_MAIN, seed=len(runs) - 2)
    rg = timed(FLASH_RG, seed=len(runs) - 1)
    record["recurrentgemma"] = {k: rg[k] for k in (
        "shape", "kernel_route", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "bytes", "flops", "library_max_abs_err")}
    return record


# B, S, H, P, N, chunk: tests/test_kernels.py's SSD_CASES, then Mamba-2's
# smoke shape, then the tile edges of the bf16 route (chunks of 64 and 256
# with N 128, P 16, H not a multiple of its head group); the overflow
# case, the strided case and the main path's shape are separate
SSD_CASES = [(2, 64, 4, 16, 32, 16), (1, 128, 8, 32, 64, 32),
             (2, 96, 4, 64, 16, 32), (2, 48, 4, 32, 16, 16),
             (2, 512, 8, 64, 128, 64), (1, 1024, 12, 64, 128, 256),
             (2, 256, 8, 16, 64, 64), (1, 256, 5, 32, 128, 128)]
SSD_MAIN = (4, 2048, 80, 64, 128, 256)           # mamba2-2.7b prefill, bf16
SSD_TOL = {torch.float32: 5e-3, torch.bfloat16: 1e-1}   # y; h_final 5e-3


def _ssd_inputs(case, dtype, dev, seed, overflow=False, strided=False):
    """tests/test_kernels.py's distributions; `overflow`: a = -16 and
    dt > 2, so exp(cum_q - cum_k) above the diagonal is inf; `strided`:
    x, b and c are slices of one (B, S, H P + 2 N) tensor, as the Mamba-2
    mixer passes its conv output."""
    B, S, H, P, N, _ = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(f(B, S, H))
    a_log = torch.rand(H, generator=gen, device=dev) * 1.5
    if overflow:
        dt, a_log = dt + 2.0, torch.full_like(a_log, float(np.log(16.0)))
    if strided:
        xs, b, c = torch.split(f(B, S, H * P + 2 * N).to(dtype),
                               [H * P, N, N], dim=-1)
        return (xs.reshape(B, S, H, P), dt, a_log, b.reshape(B, S, 1, N),
                c.reshape(B, S, 1, N), torch.ones(H, device=dev))
    return (f(B, S, H, P).to(dtype), dt, a_log, f(B, S, 1, N).to(dtype),
            f(B, S, 1, N).to(dtype), torch.ones(H, device=dev))


def ssd_phase(dev):
    from repro_torch.kernels.ssd_scan import ROUTES, ssd_scan, ssd_scan_torch
    checked = []
    runs = [(c, dt, False, False) for c in SSD_CASES for dt in SSD_TOL]
    runs += [((2, 512, 4, 64, 128, 256), torch.float32, True, False),
             ((2, 512, 8, 64, 128, 256), torch.bfloat16, False, True),
             ((2, 512, 8, 64, 128, 256), torch.float32, False, True),
             (SSD_MAIN, torch.bfloat16, False, False)]
    for i, (case, dtype, overflow, strided) in enumerate(runs):
        args = _ssd_inputs(case, dtype, dev, seed=i, overflow=overflow,
                           strided=strided)
        y, h = ssd_scan(*args, chunk=case[5])
        y_want, h_want = ssd_scan_torch(
            *(t.contiguous() for t in args), chunk=case[5])
        torch.cuda.synchronize()
        tol = SSD_TOL[dtype]
        finite = bool(torch.isfinite(y).all() and torch.isfinite(h).all())
        err = float((y.float() - y_want.float()).abs().max())
        h_err = float((h - h_want).abs().max())
        if not (finite and torch.allclose(y.float(), y_want.float(), atol=tol,
                                          rtol=tol)
                and torch.allclose(h, h_want, atol=5e-3, rtol=5e-3)):
            raise AssertionError(f"ssd_scan differs from its plain version at "
                                 f"{case} {dtype} (overflow {overflow}): "
                                 f"finite {finite}, max abs y {err}, h "
                                 f"{h_err}")
        checked.append({"case": list(case), "dtype": str(dtype)[6:],
                        "route": ROUTES[dtype], "overflow": overflow,
                        "strided": strided, "max_abs_err": err,
                        "h_max_abs_err": h_err, "tol": tol,
                        "margin": _margin(y, y_want, tol),
                        "h_margin": _margin(h, h_want, 5e-3)})
    B, S, H, P, N, Q = SSD_MAIN
    args = _ssd_inputs(SSD_MAIN, torch.bfloat16, dev, seed=len(runs) - 1)
    nc = S // Q
    # each input read once, each output written once: x, b, c, y in bf16;
    # dt, a_log, d, h_final in f32
    nbytes = (2 * (2 * B * S * H * P + 2 * B * S * N)
              + 4 * (B * S * H + 2 * H + B * H * P * N))
    # the chunked form's products: C.B^T per chunk (shared by the heads),
    # then per head the full Q x Q product with x, the chunk state and
    # the entering state's contribution
    flops = B * nc * (2 * Q * Q * N + H * (2 * Q * Q * P + 4 * Q * P * N))
    record = _kernel_record(
        "ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:67",
        lambda: ssd_scan(*args, chunk=Q),
        lambda: ssd_scan_torch(*args, chunk=Q), None,
        nbytes=nbytes, flops=flops, peak_flops=BF16_FLOP_PER_S,
        checked=checked, max_abs_err=max(c["max_abs_err"] for c in checked),
        tolerance="y 5e-3 float32, 1e-1 bfloat16; h_final 5e-3 (abs and "
                  "rel)", kernel_head_start=4_000_000,
        plain_head_start=20_000_000)
    record["shape"] = {"B": B, "S": S, "H": H, "P": P, "N": N, "chunk": Q,
                       "dtype": "bfloat16"}
    record["kernel_route"] = ROUTES[torch.bfloat16]
    record["max_margin"] = max(max(c["margin"], c["h_margin"])
                               for c in checked)
    record["library"] = "none: no single PyTorch call computes the SSD scan"
    return record


# B, S, W: tests/test_kernels.py's RGLRU_CASES, a ragged width (the
# column route) and ragged tiles of the ring route; the main path's shape
# comes last
RGLRU_CASES = [(2, 64, 128), (1, 128, 256), (3, 32, 512), (2, 37, 100),
               (2, 100, 136)]
RGLRU_MAIN = (4, 2048, 4096)                     # recurrentgemma-9b, a bf16
RGLRU_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (3e-2, 1e-2)}


def _rglru_inputs(case, dtype, dev, seed):
    """(a in `dtype`, gx, h0) from random gates, as `rglru_gated` feeds
    the kernel."""
    from repro_torch.kernels.ref import rglru_gates
    B, S, W = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, r, i = (torch.randn(B, S, W, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    lam = torch.randn(W, generator=gen, device=dev)
    a, gx = rglru_gates(x, r, i, lam)
    return a.to(dtype), gx, torch.randn(B, W, generator=gen, device=dev)


def rglru_phase(dev):
    """Each case against the plain version: bit-equal on the ring route,
    within RGLRU_TOL on the column route."""
    from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_torch,
                                                route)
    checked = []
    runs = [(c, dt) for c in RGLRU_CASES for dt in RGLRU_TOL]
    runs.append((RGLRU_MAIN, torch.bfloat16))
    for i, (case, dtype) in enumerate(runs):
        args = _rglru_inputs(case, dtype, dev, seed=i)
        path = route(*args[:2])
        y, h = rglru_scan(*args)
        y_want, h_want = rglru_scan_torch(*args)
        torch.cuda.synchronize()
        tol, htol = (0.0, 0.0) if path == "ring" else RGLRU_TOL[dtype]
        err = float((y - y_want).abs().max())
        h_err = float((h - h_want).abs().max())
        if path == "ring":
            ok = torch.equal(y, y_want) and torch.equal(h, h_want)
        else:
            ok = (torch.allclose(y, y_want, atol=tol, rtol=tol)
                  and torch.allclose(h, h_want, atol=htol, rtol=htol))
        if not ok:
            raise AssertionError(f"rglru_scan ({path}) differs from its plain "
                                 f"version at {case} {dtype}: max abs y "
                                 f"{err}, h {h_err}")
        checked.append({"case": list(case), "dtype": str(dtype)[6:],
                        "route": path, "max_abs_err": err,
                        "h_max_abs_err": h_err, "tol": tol, "htol": htol})
    if checked[-1]["route"] != "ring":
        raise AssertionError("the main path's shape is not on the ring route")
    B, S, W = RGLRU_MAIN
    args = _rglru_inputs(RGLRU_MAIN, torch.bfloat16, dev, seed=len(runs) - 1)
    # a in bf16, gx and h_seq in f32, h0 and h_last in f32; 2 ops a step
    nbytes = B * S * W * (2 + 4 + 4) + 2 * 4 * B * W
    record = _kernel_record(
        "rglru_scan", "src/repro_torch/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan.py:48",
        lambda: rglru_scan(*args), lambda: rglru_scan_torch(*args), None,
        nbytes=nbytes, flops=2 * B * S * W, peak_flops=FP32_FLOP_PER_S,
        checked=checked, max_abs_err=max(c["max_abs_err"] for c in checked),
        tolerance="ring: exact (bit-equal); column: y 1e-5 float32, 3e-2 "
                  "bfloat16; h 1e-4 float32, 1e-2 bfloat16 (abs and rel)",
        kernel_head_start=4_000_000, plain_head_start=400_000_000,
        plain_reps=5)
    record["shape"] = {"B": B, "S": S, "W": W, "a_dtype": "bfloat16"}
    record["kernel_route"] = checked[-1]["route"]
    record["library"] = ("none: no single PyTorch call computes a linear "
                         "recurrence")
    return record


def _engine(n_traces, days=1):
    from repro_torch.carbon.intensity import TraceProvider
    from repro_torch.cluster.placement import PlacementConfig, PlacementEngine
    from repro_torch.cluster.slices import paper_family
    provs = [TraceProvider.for_region(r, hours=24 * days, seed=1)
             for r in REGIONS]
    cap = int(np.ceil(0.6 * n_traces))
    return cap, PlacementEngine(
        paper_family(), provs, region_names=REGIONS,
        config=PlacementConfig(capacity=cap, min_dwell=6, hysteresis=0.10))


def _spec(demand, eng, device):
    from repro_torch.cluster.slices import paper_family
    from repro_torch.core.policy import CarbonContainerPolicy
    from repro_torch.core.spec import SweepSpec
    return SweepSpec(
        policies={"carbon_containers":
                  lambda: CarbonContainerPolicy(variant="energy")},
        family=paper_family(), traces=demand,
        targets=list(np.linspace(20.0, 80.0, N_TARGETS)),
        placement=eng, device=device)


def _check_rows(res, n_rows):
    if len(res.rows) != n_rows:
        raise AssertionError(f"{len(res.rows)} rows, expected {n_rows}")
    for k in res.keys():
        if not np.isfinite(res.col(k)).all():
            raise AssertionError(f"non-finite {k} in the sweep rows")


def cross_check(dev):
    from repro_torch.cluster.placement import plan_torch
    from repro_torch.workload.azure_like import sample_population_matrix
    demand = sample_population_matrix(5_000, days=1, seed=SEED)
    _, eng = _engine(5_000)
    p_gpu = plan_torch(eng, demand, device=dev)
    p_cpu = plan_torch(eng, demand, device="cpu")
    if not (np.array_equal(p_gpu.assign, p_cpu.assign)
            and np.array_equal(p_gpu.migrations, p_cpu.migrations)):
        raise AssertionError("card and CPU plans differ")
    plan_err = max(float(np.abs(p_gpu.overhead_g - p_cpu.overhead_g).max()),
                   float(np.abs(p_gpu.downtime_s - p_cpu.downtime_s).max()))
    r_gpu = _spec(demand, eng, dev).run()
    r_cpu = _spec(demand, eng, "cpu").run()
    _check_rows(r_gpu, N_TARGETS)
    parity = r_gpu.parity(r_cpu)
    if parity > 1e-9 or plan_err > 1e-9:
        raise AssertionError(f"card vs CPU: rows {parity}, plan {plan_err}")
    for a, b in zip(r_gpu.rows, r_cpu.rows):
        if a["migrations_mean"] != b["migrations_mean"]:
            raise AssertionError("card vs CPU migrations differ")
    return {"n_traces": 5_000, "rows_parity": parity, "plan_err": plan_err,
            "plan_migrations": int(p_gpu.migrations.sum())}


def full_width(dev):
    from repro_torch.cluster.placement import plan_torch
    from repro_torch.workload.azure_like import sample_population_matrix
    n_traces = 100_000
    t0 = time.perf_counter()
    demand = sample_population_matrix(n_traces, days=1, seed=SEED)
    gen_s = time.perf_counter() - t0
    T = demand.shape[0]
    N = n_traces * N_TARGETS
    cap, eng = _engine(n_traces)
    R = eng.n_regions

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = plan_torch(eng, demand, device=dev)      # ends in a host copy
    plan_s = time.perf_counter() - t0
    over = int((plan.occupancy() > cap).sum())
    if over:
        raise AssertionError(f"{over} over-capacity region-epochs")

    spec = _spec(demand, eng, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    res = spec.run()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = _read_counts()
    want = {name: 0 for name in launches}
    want["admission_round"] = T                    # one call an epoch
    if launches != want:
        raise AssertionError(f"kernel launches {launches} on the sweep's "
                             f"main path, expected {want}")
    _check_rows(res, N_TARGETS)
    if res.rows[0]["placement_migrations_mean"] != float(
            np.mean(plan.migrations)):
        raise AssertionError("the sweep's plan differs from the one checked")
    # where the time goes: the plan alone, then the whole sweep, profiled
    # (after the counted run, so profiling costs it nothing)
    plan_prof = _device_profile(lambda: plan_torch(eng, demand, device=dev))
    sweep_prof = _device_profile(spec.run)
    profile = {"plan": dict(zip(("wall_s", "device_s", "top"), plan_prof)),
               "sweep": dict(zip(("wall_s", "device_s", "top"),
                                 sweep_prof))}
    if sweep_prof[1] is not None:
        profile["sweep_device_busy_share"] = sweep_prof[1] / sweep_s
    return {"n_traces": n_traces, "n_targets": N_TARGETS,
            "n_containers": N, "n_epochs": T, "n_regions": R,
            "capacity": cap, "gen_s": gen_s, "plan_s": plan_s,
            "sweep_s": sweep_s, "container_epochs_per_s": N * T / sweep_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "over_capacity_epochs": over, "launches": launches,
            "plan_migrations": int(plan.migrations.sum()),
            "rows": res.rows, "profile": profile}


def _kernel_counters():
    """{library name: the wrapper whose `launches` counts that kernel's
    launches}."""
    from repro_torch.cluster.placement_kernel import admission_rounds
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"admission_round": admission_rounds,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan,
            "rglru_scan": rglru_scan}


def _zero_counts():
    for fn in _kernel_counters().values():
        fn.launches = 0
        for path in getattr(fn, "route_launches", {}):
            fn.route_launches[path] = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_counters().items()}


def _read_routes() -> dict:
    """{kernel: {route: launches}} for the kernels with several routes."""
    return {name: dict(fn.route_launches)
            for name, fn in _kernel_counters().items()
            if hasattr(fn, "route_launches")}


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP")


def sass_counts(libs) -> dict:
    """Tensor-core and TMA instructions in each built kernel function,
    from `cuobjdump -sass`: {library: {function: {op: n}}} for the ops of
    SASS_OPS."""
    import os
    import re
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / (
        "cuobjdump")
    out = {}
    for name, path in libs.items():
        sass = subprocess.run([str(tool), "-sass", str(path)], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout
        funcs, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                funcs[fn] = dict.fromkeys(SASS_OPS, 0)
            elif fn is not None:
                op = re.search(rf"\b({'|'.join(SASS_OPS)})\b", line)
                if op:
                    funcs[fn][op.group(1)] += 1
        out[name] = funcs
    want = {("flash_attention", "flash_fwd_wgmma", ("HGMMA",)),
            ("ssd_scan", "ssd_states_mma", ("HMMA",)),
            ("ssd_scan", "ssd_out_mma", ("HMMA",)),
            ("rglru_scan", "rglru_ring", ("UTMALDG", "UBLKCP"))}
    for lib, kernel, ops in want:
        found = [f for f in out[lib] if kernel in f]
        if not found or not all(any(out[lib][f][op] for op in ops)
                                for f in found):
            raise AssertionError(f"{lib}: no {' or '.join(ops)} instructions "
                                 f"in {kernel} "
                                 f"({ {f: out[lib][f] for f in found} })")
    return out


def _serving_model(arch, dtype=None, **overrides):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.api import get_model
    cfg = get_arch(arch).full
    cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype, **overrides)
    return get_model(cfg)


# arch, depth and overrides of the card-vs-CPU checks (float32, the
# published widths): phi4-mini and Mamba-2 at 2 layers; RecurrentGemma
# at one superlayer plus one trailing recurrent block, so both scan
# groups run, with its window cut to 128 so that it bites in the
# prefill's flash launch and the ring wraps in decode
SERVE_CROSS = [("phi4-mini-3.8b", 128, {"n_layers": 2}),
               ("mamba2-2.7b", 256, {"n_layers": 2}),
               ("recurrentgemma-9b", 256, {"n_layers": 4,
                                           "local_window": 128})]


def serving_cross_check(dev, arch, prompt_len, overrides):
    """The same weights and tokens on the card and on the CPU in
    float32: prefill, then 8 decode steps fed the CPU's greedy tokens;
    every step's logits within 1e-3."""
    from repro_torch.models.params import tree_map
    model = _serving_model(arch, dtype="float32", **overrides)
    cpu_params = model.init(SEED, device="cpu")
    params = tree_map(lambda t: t.to(dev), cpu_params)
    prompts = np.random.default_rng(SEED).integers(
        0, model.cfg.vocab_size, (2, prompt_len))
    tokens = torch.as_tensor(prompts)
    _zero_counts()
    a, ca = model.prefill(params, {"tokens": tokens.to(dev)},
                          pad_to=prompt_len + 8)
    launches = {k: v for k, v in _read_counts().items() if v}
    b, cb = model.prefill(cpu_params, {"tokens": tokens},
                          pad_to=prompt_len + 8)
    errs, agree, steps = [], 0, 0
    for step in range(9):
        a = a.cpu()
        err = float((a - b).abs().max())
        if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
            raise AssertionError(f"{arch}: card vs CPU logits differ at step "
                                 f"{step}: max abs {err}")
        errs.append(err)
        tok = torch.argmax(b, -1)
        agree += int((torch.argmax(a, -1) == tok).sum())
        steps += tok.numel()
        if step < 8:
            a, ca = model.decode(params, ca, tok.to(dev))
            b, cb = model.decode(cpu_params, cb, tok)
    return {"arch": arch, **overrides, "dtype": "float32", "batch": 2,
            "prompt_len": prompt_len, "decode_steps": 8,
            "prefill_launches": launches, "max_abs_err": max(errs),
            "errs": errs, "greedy_agree": agree, "greedy_total": steps}


# arch, the config switch that sends its kernel's layer to the plain
# version: the bf16 kernels-vs-plain prefill check at the published widths
BF16_CHECK = [("phi4-mini-3.8b", "attn_impl", "flash_attention"),
              ("mamba2-2.7b", "ssm_impl", "ssd_scan")]
BF16_LAYERS, BF16_BATCH = 2, 2


def kernels_vs_plain_bf16(dev, arch, switch, kernel):
    """Prefill logits of the same bf16 weights and prompts with the
    kernels (impl "auto") and with the plain versions (impl "ref") at the
    published widths, 2 layers, 2 x 2,048 tokens; within 2e-2 of the
    largest |logit|. Holds the kernels' roundings through real layers."""
    fast = _serving_model(arch, n_layers=BF16_LAYERS)
    plain = _serving_model(arch, n_layers=BF16_LAYERS, **{switch: "ref"})
    params = fast.prepare(fast.init(SEED, device=dev))
    prompts = np.random.default_rng(SEED).integers(
        0, fast.cfg.vocab_size, (BF16_BATCH, SERVE_PROMPT))
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    _zero_counts()
    got, _ = fast.prefill(params, batch)
    torch.cuda.synchronize()
    launches, routes = _read_counts(), _read_routes()
    want, _ = plain.prefill(params, batch)
    if launches[kernel] != BF16_LAYERS or routes[kernel][
            MAIN_ROUTES[kernel]] != BF16_LAYERS:
        raise AssertionError(f"{arch}: {kernel} launches {launches[kernel]}"
                             f", routes {routes[kernel]}; expected "
                             f"{BF16_LAYERS} on {MAIN_ROUTES[kernel]}")
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= 2e-2 * scale):
        raise AssertionError(f"{arch}: bf16 prefill logits with the kernels "
                             f"differ from the plain versions by {err} "
                             f"(max |logit| {scale})")
    return {"arch": arch, "n_layers": BF16_LAYERS, "dtype": "bfloat16",
            "batch": BF16_BATCH, "prompt_len": SERVE_PROMPT,
            "plain_switch": f"{switch}=ref", "launches": launches[kernel],
            "routes": routes[kernel], "max_abs_err": err,
            "max_abs_logit": scale, "err_over_max_logit": err / scale,
            "tol": "2e-2 * max|logit|"}


# arch, the kernel launches of one prefill (one generate) at full width;
# every flash and SSD launch there takes the tensor-core route, every
# RG-LRU launch the TMA ring
SERVE_FULL = [("phi4-mini-3.8b", {"flash_attention": 32}),
              ("mamba2-2.7b", {"ssd_scan": 64}),
              ("recurrentgemma-9b", {"rglru_scan": 26,
                                     "flash_attention": 12})]
MAIN_ROUTES = {"flash_attention": "wgmma", "ssd_scan": "mma_sync",
               "rglru_scan": "ring"}


def serving_full_width(dev, arch, expected, warmup_len):
    """`ServeEngine.generate` of 32 greedy tokens after 4 prompts of
    2,048 random tokens at the published widths and depth, seeded random
    weights; then a torch.profiler breakdown of one prefill and one
    decode step."""
    from repro_torch.serve.engine import ServeEngine, throughput_tokens_per_s
    model = _serving_model(arch)
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine = ServeEngine(model, device=dev).load(SEED)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
    engine.generate(prompts[:, :warmup_len], 2)    # warm-up (cuBLAS, caches)
    engine.stats = dict.fromkeys(engine.stats, 0)

    _zero_counts()
    out = engine.generate(prompts, SERVE_NEW_TOKENS, duty=1.0)
    torch.cuda.synchronize()
    launches = _read_counts()
    routes = _read_routes()
    want = {name: expected.get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"{arch}: kernel launches {launches} on the "
                             f"serving path, expected {want} (one prefill)")
    for name, path in MAIN_ROUTES.items():
        if routes[name].get(path, 0) != want[name]:
            raise AssertionError(f"{arch}: {name} routes {routes[name]}, "
                                 f"expected all {want[name]} on {path}")
    toks = out["tokens"]
    if toks.shape != (SERVE_BATCH, SERVE_NEW_TOKENS) or toks.min() < 0 or (
            toks.max() >= cfg.vocab_size):
        raise AssertionError(f"{arch}: generated tokens of shape "
                             f"{toks.shape} in [{toks.min()}, {toks.max()}]")
    peak = torch.cuda.max_memory_allocated(dev)
    if peak >= torch.cuda.get_device_properties(dev).total_memory:
        raise AssertionError(f"{arch}: peak memory {peak} B")
    tp = throughput_tokens_per_s(out["stats"])

    # where the time goes: one prefill and one decode step, profiled
    params = engine.prepared_params()
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    res = {}
    pre = _device_profile(lambda: res.update(zip(("logits", "cache"), (
        model.prefill(params, batch, pad_to=SERVE_PROMPT + 1)))))
    logits = res["logits"]
    if tuple(logits.shape) != (SERVE_BATCH, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: prefill logits are not finite of "
                             f"shape (B, V)")
    dec = _device_profile(lambda: model.decode(
        params, res["cache"], torch.argmax(logits, -1)))
    profile = {name: dict(zip(("wall_s", "device_s", "top"), prof))
               for name, prof in (("prefill", pre), ("decode_step", dec))}
    return {"arch": arch, "params": model.param_count(),
            "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
            "new_tokens": SERVE_NEW_TOKENS, "load_s": load_s,
            "prefill_s": out["stats"]["prefill_s"],
            "decode_s": out["stats"]["decode_s"], **tp,
            "max_memory_allocated": peak, "launches": launches,
            "route_launches": routes, "tokens_head": toks[:, :8].tolist(),
            "profile": profile}


def _free_device_memory():
    gc.collect()
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs the port on a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import cuda_build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    libs = cuda_build.build(list(_kernel_counters()))
    build_s = time.perf_counter() - t0
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            print(f"[{name}] {log.read_text().strip()}", flush=True)

    sass = sass_counts(libs)
    for lib, funcs in sass.items():
        found = {f: {op: c for op, c in n.items() if c}
                 for f, n in funcs.items() if any(n.values())}
        print(f"[{lib}] tensor-core and TMA instructions (cuobjdump -sass): "
              f"{json.dumps(found)}", flush=True)

    kernels = {r["name"]: r for r in (admission_phase(dev), flash_phase(dev),
                                      ssd_phase(dev), rglru_phase(dev))}
    for name in ("flash_attention", "ssd_scan", "rglru_scan"):
        kernels[name]["sass"] = sass[name]
    bf16_check = [kernels_vs_plain_bf16(dev, arch, switch, kernel)
                  for arch, switch, kernel in BF16_CHECK]
    _free_device_memory()
    cross = cross_check(dev)
    full = full_width(dev)
    _free_device_memory()
    serve_cross = [serving_cross_check(dev, arch, n, ov)
                   for arch, n, ov in SERVE_CROSS]
    _free_device_memory()
    serve = []
    for arch, expected in SERVE_FULL:
        warmup = 128 if arch == "phi4-mini-3.8b" else 256
        serve.append(serving_full_width(dev, arch, expected, warmup))
        _free_device_memory()

    # launches: the count of each kernel over the main paths that run it
    by_path = {"placed_sweep": full["launches"],
               **{r["arch"]: r["launches"] for r in serve}}
    for name, record in kernels.items():
        record["launches_by_path"] = {path: counts[name] for path, counts in
                                      by_path.items() if counts[name]}
        record["launches"] = sum(record["launches_by_path"].values())
        if not record["launches"]:
            raise AssertionError(f"{name} was not launched on a main path")
    kernels = list(kernels.values())
    total_s = time.perf_counter() - t_start

    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "total_s": total_s, "kernels": kernels, "cross_check": cross,
              "full_width": full, "serving_cross_check": serve_cross,
              "bf16_kernels_vs_plain": bf16_check, "serving": serve}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    summary = {k: v for k, v in full.items() if k not in ("rows", "profile")}
    summary["sweep_device_s"] = full["profile"]["sweep"]["device_s"]
    summary["plan_device_s"] = full["profile"]["plan"]["device_s"]
    serve_summary = []
    for r in serve:
        row = {k: v for k, v in r.items() if k != "profile"}
        for name, prof in r["profile"].items():
            row[name] = {"wall_s": prof["wall_s"],
                         "device_s": prof["device_s"],
                         "top": prof["top"][:6]}
        serve_summary.append(row)
    print(json.dumps({"build_s": build_s, "total_s": total_s,
                      "cross_check": cross, "full_width": summary,
                      "serving_cross_check": [
                          {k: v for k, v in r.items() if k != "errs"}
                          for r in serve_cross],
                      "bf16_kernels_vs_plain": bf16_check,
                      "serving": serve_summary}), flush=True)
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k not in ("checked", "sass")}
                                  for r in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
