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
     and 1e-4 / 1e-2 (h) on its column route. Flash is also checked and
     timed at each serving path's prefill shape: RecurrentGemma's, OLMoE's
     (16:16 heads of 128), DBRX's (48:8), Whisper-base's encoder
     (non-causal over 1,500 frames) and cross-attention (4 rows against
     1,500 keys), all Dh 64 or more on the wgmma route. Each case
     records its route and its margin (the share of the allclose bar its
     worst element uses). Each kernel is timed with CUDA events at its
     main path's shape, beside one PyTorch library call where one
     computes the same function, and the least time the card could take
     (`bound_ms`);
  3b. bf16 through real layers: phi4-mini, mamba2, olmoe-1b-7b and
     dbrx-132b at their published widths, 2 layers, prefill logits with
     the kernels against the plain versions (``attn_impl``/``ssm_impl``
     "ref"), within 2e-2 of the max |logit|;
  3c. flash attention under autograd
     (`FlashAttentionFn`: the kernel writing each row's log-sum-exp, the
     reference's recomputing backward in float32) at
     tests/test_kernels.py's float32 cases and SmolLM-135M's training
     microbatch (8 x 4,096, 9:3 heads of 64, bf16): the lse within
     1e-5 (f32) / 1e-4 (bf16) of `_flash_fwd_inner`'s, out at the flash
     bars, dq / dk / dv within 1e-4 / 2e-2 of max |g| of autograd
     through `attention_ref`; times of the forward with lse, the
     backward and SDPA forward + backward;
  3d. the SSD and RG-LRU kernels under autograd: `SSDScanFn` (the
     kernel forward, the recompute and autodiff of `ssd_chunked`,
     float32 inside, as its backward) at tests/test_kernels.py's SSD cases in
     float32 and Mamba-2 smoke's mixer shape in bf16: one kernel launch
     and y at the kernel's bars (the kernel checks); its gradients
     equal autograd through `ssd_chunked` by construction, which checks
     the Function's wiring only (phase 8's Mamba-2 step holds the
     card's gradients against the CPU's);
     `RGLRUScanFn` (the kernel forward, and the kernel again on the
     reversed recurrence as its backward) at the RG-LRU cases and the
     training shape (2, 4,096, 4,096): its (da, dgx, dh0) bit-equal to
     the plain reverse loop `rglru_scan_bwd_torch` on the ring route,
     and in float32 `rglru_gated`'s gradients within 1e-5 of max |g| of
     autograd through `rglru_ref`; each backward timed at the full-width
     training microbatch beside its bound;
  4. sweep cross-check: the placed sweep at 5,000 traces x 10 targets x
     288 epochs on the card and on the CPU: rows within 1e-9, plans equal;
  5. sweep at full width: the placed sweep of
     `benchmarks/figs.py::jax_sweep_scale` without its traffic, energy,
     elasticity and fault layers: 100,000 Azure-like traces x 10 targets
     (N = 1,000,000 containers), 288 five-minute epochs, regions
     PL/NL/CAISO at capacity 60,000 each, CarbonContainerPolicy("energy"),
     through `SweepSpec(...).run()`;
  5b. device arithmetic: `repro_torch.devmath`'s divide and fixed-order
     sums bit-equal on the card and the CPU (beside them, how often
     ``x / 3600.0`` and `torch.cumsum` differ), and the greedies' budget
     cut (`budget_admits`) NumPy's at 400,000 entries, for a budget
     within rounding of a prefix sum and one far from all; then the
     layered cross-check, card against CPU, at 2,000 traces x 10
     targets, one day, in jax_sweep_scale's layer and fault settings
     (`repro_torch.launch.sweep_scale`): the faulted plan, the traffic
     replicas with and without a carbon budget, the elastic levels epoch
     by epoch under a budget that refuses some levels (also against the
     NumPy layer's, whose cut is ``np.cumsum``'s), and the rows (a)
     with all four layers and the fault plan, (b) without elasticity, so
     that the traffic and energy steps run folded into the fleet scan.
     Rows within 1e-6; plans, migrations, failed migrations, replica and
     level counts exactly;
  5c. the layered sweep at full width: jax_sweep_scale itself, phase 5's
     fleet with traffic (1,000,000 users), energy (an outage and a
     shock), elasticity (a shaped budget of 2.5 g per trace per epoch)
     and the fault plan; T admission launches, no over-capacity
     region-epoch, no energy cap or state-of-charge violation; device
     time (torch.profiler) and host time by stage (cProfile); then the
     elastic levels at 100,000 traces against the NumPy layer's;
  5d. the scenario stress matrix (`repro_torch.energy.scenarios`): at the
     reference's shape (T = 288, 24 traces, targets 40 and 80 g/h) on the
     card and on the CPU, every cell ok, rows within PARITY_TOL with the
     same keys and the counts exact, plans equal; then every cell at
     100,000 traces (400,000 containers, the energy step folded into the
     fleet scan on the card): T admission launches, conservation <= 1e-6
     W, no cap or state-of-charge violation, per cell `sweep_s`,
     container-epochs/s, peak memory, unmet energy and outage epochs, and
     one cell's device busy share and host time by stage;
  5e. custom policies: subclassed CarbonAgnosticPolicy and
     CarbonContainerPolicy, which run their own `decide_batch` on the
     host once an epoch, at 2,000 traces x 1 target x 288 epochs, placed:
     rows within 1e-9 of the stock kernels', counts exact;
  6. serving cross-checks at the published widths in float32, the same
     weights on the card and on the CPU, batch 2, then 8 decode steps fed
     the CPU's greedy tokens, every step's logits within 1e-3:
     phi4-mini-3.8b at 2 layers (128-token prompts), mamba2-2.7b at 2
     layers (256), recurrentgemma-9b at 4 layers, one superlayer and one
     trailing recurrent block (256; its window cut to 128, so that it
     bites in the prefill and the ring wraps in decode), olmoe-1b-7b at 2
     layers (64; every routing's expert ids equal on both, with the
     smallest top-k / top-(k+1) probability gap reported), whisper-base
     whole (2 clips of 1,500 seeded random frames, 4-token prompts);
  7. serving at full width, one engine at a time: phi4-mini-3.8b,
     mamba2-2.7b, recurrentgemma-9b, olmoe-1b-7b and dbrx-132b (at 2 of
     its 40 layers: 132 B parameters do not fit one 80 GB card) with
     seeded random weights on the card, `ServeEngine.generate` of 32
     greedy tokens after 4 prompts of 2,048 random tokens, and
     whisper-base on 8 clips of 1,500 (zero) frames with 4-token prompts;
     then a torch.profiler breakdown of one prefill and of one decode
     step; the MoE models' first-layer router drops, Whisper's encoder
     frames per second; peak memory under 80 GB;
  7b. carbon-aware serving on the loaded phi4-mini engine
     (`repro_torch.launch.carbon_serve`): the decode capacity calibrated
     on the card, the 96-interval control loop, and the duty it chose
     applied to `generate`: the decode loop's wall time over its
     device-synced step time must be 1/duty within 10 %;
  8. training card vs CPU, one AdamW step of each family at its
     published widths and reduced depth in float32 from the same state:
     SmolLM-135M at 2 layers (2 x 512 tokens), mamba2-2.7b at 2 layers
     (2 x 512), recurrentgemma-9b at 3 layers, one superlayer (2 x 256;
     window cut to 128 so that it bites), whisper-base with 2 + 2
     layers (2 clips of 1,500 seeded frames, 64 tokens), the last three
     in 2 microbatches: loss and grad_norm within 1e-3 relative, m and v
     within 1e-3 of each leaf's max, params within 1e-3, the updates
     (params after minus before) within 1e-3 relative + 1e-2 of the
     learning rate save for at most 1e-4 of the entries; each kernel's
     launches on its float32 route exact; each run prints the leaf with
     the worst card-vs-CPU error of m, of v and of the gradients (m is
     (1 - b1) x the clipped gradient after this first step);
  9. training at the published widths, seeded weights, `SyntheticLM`
     tokens (and seeded bf16 frames), bf16 activations, f32 masters,
     AdamW, each step spending its state: a warm-up step on one
     microbatch, profiled (where a microbatch's time goes), then timed
     steps: SmolLM-135M whole (30 layers, d 576, 9:3 x 64, vocab
     49,152; 4,096 x 256 tokens a step in microbatches of 8, no remat,
     3 steps); mamba2-2.7b whole (64 layers, 2,702,579,200 parameters)
     and recurrentgemma-9b at 8 of its 38 layers (2 superlayers and the
     2 trailing recurrent blocks; all 38 do not fit one card's AdamW
     state), both 8 x 4,096 tokens a step in microbatches of 2 with
     remat "full" and "dots"; whisper-base whole, 64 clips of 1,500
     frames and 448 tokens a step in microbatches of 16 (2 steps each).
     Each reports `step_time_s`, `train_tok_s`, `mfu`, peak memory (<
     80 GB), the losses and its cuts;
  10. the carbon-aware trainer (`CarbonAwareTrainer` over an
     `ElasticJob`) on SmolLM-135M at full width, sequence 4,096, global
     batch 8, virtual clock, 6 steps: a duty below 1, a migration
     between two slices (both this card) and a suspend/resume; every restore
     bit-equal to its checkpoint, every loss equal to an uninterrupted
     job's, average C(t) within 1.1 x the target;
  10b. mesh_train: training sharded over the cards, W =
     torch.cuda.device_count() processes (spawned, one card each, NCCL,
     TF32 off, one time limit for all): SmolLM-135M whole and
     OLMoE-1B-7B at its published widths (d 2,048, 64 experts, top-8,
     16:16 heads of 128, vocab 50,304) and 2 of its 16 layers, both in
     float32, 1,024 x 8 tokens a step, 2 steps, on the mesh (data W,
     model 1) and, for an even W, (data W/2, model 2), where SmolLM's
     model axis drops on the 9 heads and stays on d_ff and the
     vocabulary, and OLMoE's splits the heads, the vocabulary and the
     experts (expert-parallel, capacity per data shard); every step
     held against the same step unsharded on card 0 at phase 8's bars
     (`_hold_train_step`), OLMoE's in microbatches of one data shard's
     rows; the first step's collectives counted (wire bytes per device
     by kind, the roofline's collective seconds at NVLink's 450 GB/s a
     direction); then Mamba-2 (2 of 64 layers, 8 x 1,024 tokens),
     RecurrentGemma (one superlayer, 3 of 38 layers, 2 x 1,024 tokens)
     and Whisper-base (whole, 8 clips x 448 tokens) at their published
     widths in float32 on the same meshes, each step held against the
     unsharded step on card 0 leaf by leaf on the card, each card's
     SSD, RG-LRU and flash launches counted per route every step, the
     peak GB per card; with W >= 2, each mesh's first-step collective
     records on rank 0 held item for item against the same step as one
     device of an abstract mesh (`Mesh.abstract`, no process group) at
     rank 0's coordinates; then an ElasticJob of SmolLM on all W cards
     migrates to the first ceil(W/2) and back, its state bit-equal
     across each reshard (cuda:0 to cuda:0 with one card);
  10c. mesh_serve: serving sharded over the cards, W processes as in
     10b, on the meshes (W, 1) and, for W >= 2, (1, W) (expert-parallel
     over every card); phi4-mini-3.8b, olmoe-1b-7b and mamba2-2.7b at
     their published widths and 2 layers, recurrentgemma-9b at 4 (its
     window cut to 128) and whisper-base whole (4 clips of seeded
     frames), in float32: prefill and 8 decode steps on each mesh (the
     decode caches split over their slots, Mamba-2's and the RG-LRU's
     states over heads and channels, where the model axis divides them)
     against the unsharded model on card 0 run on each data shard's
     prompts alone, every step's logits within 1e-3 and the greedy
     tokens equal; then each at full width in bf16 at phase 7's shapes,
     `ServeEngine(mesh=)` generating 32 greedy tokens: prefill and
     decode tokens per second (Whisper's frames per second), peak GB
     per card, the wire bytes per device by kind of one prefill and one
     decode step, each kernel's launches by route and OLMoE's
     first-layer router_dropped. With one card both phases run the mesh
     path on a (1, 1) mesh and issue no collective;
  11. the single-card dry run (`python -m repro_torch.launch.dryrun
     --all`): the 40 cells, 32 run and 8 skipped with the reference's
     reasons; each cell's memory from its abstract trees with
     ``cards_needed``, its model FLOPs (equal to the host formula's),
     and its marginal-layer probes at the published widths (FLOPs > 0;
     a probe whose parameters and state do not fit the card says so);
     the cost counter's calls equal the kernels' launches; then the
     roofline of the cells (`repro_torch.launch.roofline`), SmolLM-135M
     at train_4k with phase 9's step time and an mfu equal to phase 9's;
  11b. dryrun_mesh: the dry run as one device of the reference's
     production meshes (abstract meshes: one device's share on this
     card, no process group): `dryrun --mesh single` on the four
     hill-climb cells (chameleon-34b and smollm-135m train_4k, dbrx-132b
     train_4k, starcoder2-15b decode_32k), recurrentgemma-9b train_4k
     (all 38 layers) and mamba2-2.7b and whisper-base prefill_32k;
     `dryrun --mesh multi` on chameleon-34b train_4k; the hill-climb
     variants A1, A6, A9, B1, B3, C1, C2, D1 and D2 (every lever:
     microbatch, mesh shape, rules override, remat, config fields).
     Each cell's per-device argument bytes equal the host formula's
     (`mesh_memory_stats` over a plain {axis: size} mapping), DBRX's
     train cell is probed, every mesh of more than one device records
     wire bytes > 0, B1 and B3 (`PURE_DP`) record only all-reduces over
     "model" (gradients and statistics: "model" is a batch axis there),
     C2 (`SERVE_TP`) gathers nothing over "data", and the cost counter's
     calls equal the kernels' launches;
  12. the reference's entry points (`repro_torch.examples`) on the card
     at the reference's defaults, each held to its own verdict
     (quickstart's loss falls; carbon_train's average C(t) <= its
     target over 200 steps; the elasticity forecast saves carbon within
     the oracle's bound with no budget violation; carbon routing emits
     less per request; the 10,080-container placed sweep equals the
     CPU's rows), then the sweep examples at a reduced size, card
     against CPU, summaries equal.

Phases 5, 5c, 5d (each full-width cell), 5e (the agnostic subclass), 7,
7b, 9 (each model's timed steps), 10, 10b (each mesh's steps), 10c (each
mesh's generate), 11, 11b and 12
(the defaults' runs)
are the main paths (11, 11b and 12 are counted, not pinned): every
kernel's launch counter is set to 0
just before each path and read just after; each path must have launched
exactly its kernels (T admission launches in each sweep, one per epoch;
per prefill 32 flash launches for phi4-mini, 64 SSD launches for
Mamba-2, 26 RG-LRU and 12 flash launches for RecurrentGemma, 16 flash
launches for OLMoE, 2 for DBRX, 18 for Whisper; two phi4-mini prefills
in 7b; in 9 a step of SmolLM 960 flash launches with lse, of Mamba-2
512 SSD launches (64 layers x 4 microbatches, twice under remat), of
RecurrentGemma 72 RG-LRU launches (6 recurrent blocks x 4
microbatches: forward, the remat's recompute and the backward) and 16
flash launches with lse (2 x 4, twice), of Whisper 72 flash launches
with lse (6 encoder + 12 decoder attentions x 4 microbatches); 30 flash
launches with lse a step in 10, and a step of SmolLM on each card in
10b (2 for OLMoE's), on the float32 cuda_core route, and of Mamba-2 2
SSD launches (cuda_core), of RecurrentGemma 4 RG-LRU (ring) and 1
flash, of Whisper 18 flash; in 10c phase 7's launches per generate on
each card, on their bf16 routes) and no others, every flash launch on
the wgmma route (with lse in 9 and 10), every SSD launch on the
mma_sync route (10b's float32 ones on cuda_core) and every RG-LRU
launch on the ring route.

Prints the nvidia-smi line, one line of phase results, the training
line, the roofline table, the dry-run and examples line, the
``kernels`` JSON line, and last ``{"ok": true, "device": {...}}``. The full record
goes to ``chiprun_out/chip_smoke.json``.
"""
import dataclasses
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
FULL_TRACES = 100_000           # x N_TARGETS = 1,000,000 containers
LAYERED_CROSS_TRACES = 2_000    # the layered card-vs-CPU check
SERVE_PROMPT, SERVE_NEW_TOKENS = 2048, 32
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
    device activity. The profiler's raw events are summed directly:
    `key_averages` builds Python events for every record first, which
    takes tens of seconds on a sweep's hundreds of thousands."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation() and e.duration_ns() > 0):
            ns, count = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), count + 1)
    kernels = sorted(((ns, count, name) for name, (ns, count)
                      in by_name.items()), reverse=True)
    dev_s = sum(k[0] for k in kernels) / 1e9 if kernels else None
    top = [{"name": k[2][:120], "device_s": k[0] / 1e9, "count": k[1]}
           for k in kernels[:12]]
    return wall, dev_s, top


# the sweep's stages, by function name, for the host-time breakdown
HOST_STAGES = ("run_scenario", "_shared_inputs", "sweep_population_torch",
               "_prepare_sweep_inputs",
               "plan_torch", "migration_failure_mask", "observe_intensity",
               "request_matrix", "simulate_traffic", "_prepare_energy",
               "simulate_supply", "simulate_elastic_torch", "forecast_series",
               "_elastic_budget_series", "_fleet_scan", "run",
               "_aggregate_sweep_rows")


def _host_breakdown(fn):
    """Run `fn` under cProfile; returns (wall_s, {module.function:
    cumulative s}) for the port's functions named in HOST_STAGES. Device
    work is asynchronous, so a stage's time includes the waits for the
    card at its host copies."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    out = {}
    for (path, _, name), row in pstats.Stats(prof).stats.items():
        if "repro_torch" in path and name in HOST_STAGES:
            key = f"{Path(path).stem}.{name}"
            out[key] = out.get(key, 0.0) + row[3]
    return wall, dict(sorted(out.items(), key=lambda kv: -kv[1]))


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
    rate for their type (`dryrun_lib.HW`: the H100 SXM data sheet)."""
    from repro_torch.launch.dryrun_lib import HW
    ms = _median_ms(kernel, head_start_cycles=kernel_head_start)
    plain_ms = _median_ms(plain, reps=plain_reps,
                          head_start_cycles=plain_head_start)
    library_ms = (_median_ms(library, head_start_cycles=kernel_head_start)
                  if library is not None else None)
    byte_ms = nbytes / HW["hbm_bw"] * 1e3
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
    from repro_torch.kernels import cost
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
    flops, nbytes = cost.admission_rounds(N, R, R)
    record = _kernel_record(
        "admission_round", "src/repro_torch/csrc/admission_round.cu",
        "src/repro/cluster/placement_pallas.py:120",
        lambda: admission_rounds(*args, R),
        lambda: admission_rounds_torch(*args, R),
        None, nbytes=nbytes, flops=flops, peak_flops=None, checked=checked,
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
# 256), then the carbon-serve calibration prefill (phi4-mini's heads, 4 x
# 8 tokens) and Whisper's card-vs-CPU shapes (2 clips: the encoder's 1,500
# frames, the cross-attention of 4 rows); the main paths' shapes come last
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
               (2, 1000, 1000, 8, 8, 256, False, 300),
               (4, 8, 8, 24, 8, 128, True, 0),
               (2, 1500, 1500, 8, 8, 64, False, 0),
               (2, 4, 1500, 8, 8, 64, False, 0)]
FLASH_MAIN = (4, 2048, 2048, 24, 8, 128, True, 0)   # phi4-mini prefill, bf16
# the other main paths' prefill shapes, bf16: each checked against the
# plain version and timed beside its bound and SDPA
FLASH_SHAPES = {
    "recurrentgemma": (4, 2048, 2048, 16, 1, 256, True, 2048),
    "olmoe": (4, 2048, 2048, 16, 16, 128, True, 0),
    "dbrx": (4, 2048, 2048, 48, 8, 128, True, 0),
    "whisper_encoder": (8, 1500, 1500, 8, 8, 64, False, 0),
    "whisper_cross": (8, 4, 1500, 8, 8, 64, False, 0),
}
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(case, dtype, dev, seed):
    """q, k, v of a case (B, Sq, Skv, Hq, Hkv, Dh, causal, window)."""
    B, Sq, Skv, Hq, Hkv, Dh = case[:6]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(B, S, h, Dh, generator=gen, device=dev).to(dtype)
                 for S, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))


def flash_phase(dev):
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch,
                                                     route)
    from repro_torch.launch.dryrun_lib import HW
    checked = []
    main = [FLASH_MAIN, *FLASH_SHAPES.values()]
    runs = [(c, dt) for c in FLASH_CASES for dt in FLASH_TOL]
    runs += [(c, torch.bfloat16) for c in main]
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
        B, Sq, Skv, Hq, Hkv, Dh, causal, window = case
        q, k, v = _qkv(case, torch.bfloat16, dev, seed=seed)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if 0 < window < Skv or (causal and Sq != Skv):
            raise ValueError("the library yardstick is attention without a "
                             "window that bites, causal only for Sq = Skv")

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
        library_err = float((library().transpose(1, 2).float()
                             - flash_attention_torch(q, k, v, causal=causal)
                             .float()).abs().max())
        flops, nbytes = cost.flash_attention(B, Sq, Skv, Hq, Hkv, Dh, 2,
                                             causal, window)
        record = _kernel_record(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:78",
            lambda: flash_attention(q, k, v, causal=causal, window=window),
            lambda: flash_attention_torch(q, k, v, causal=causal,
                                          window=window),
            library,
            nbytes=nbytes, flops=flops, peak_flops=HW["peak_flops_bf16"],
            checked=checked,
            max_abs_err=max(c["max_abs_err"] for c in checked),
            tolerance="2e-5 float32, 2e-2 bfloat16 (abs and rel)",
            kernel_head_start=2_000_000, plain_head_start=20_000_000)
        record["shape"] = {"B": B, "Sq": Sq, "Skv": Skv, "Hq": Hq,
                           "Hkv": Hkv, "Dh": Dh, "dtype": "bfloat16",
                           "causal": causal, "window": window}
        record["library"] = ("torch.nn.functional."
                             f"scaled_dot_product_attention(is_causal="
                             f"{causal}, enable_gqa=True)")
        record["library_max_abs_err"] = library_err
        record["kernel_route"] = route(torch.bfloat16, Dh)
        record["max_margin"] = max(c["margin"] for c in checked)
        return record

    first = len(runs) - len(main)
    record = timed(FLASH_MAIN, seed=first)
    for j, (name, case) in enumerate(FLASH_SHAPES.items(), start=1):
        other = timed(case, seed=first + j)
        record[name] = {k: other[k] for k in (
            "shape", "kernel_route", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bytes", "flops", "library_max_abs_err")}
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
    from repro_torch.kernels import cost
    from repro_torch.kernels.ssd_scan import ROUTES, ssd_scan, ssd_scan_torch
    from repro_torch.launch.dryrun_lib import HW
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
    flops, nbytes = cost.ssd_scan(B, S, H, P, N, Q, 2)
    record = _kernel_record(
        "ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:67",
        lambda: ssd_scan(*args, chunk=Q),
        lambda: ssd_scan_torch(*args, chunk=Q), None,
        nbytes=nbytes, flops=flops, peak_flops=HW["peak_flops_bf16"],
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
    from repro_torch.kernels import cost
    from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_torch,
                                                route)
    from repro_torch.launch.dryrun_lib import HW
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
    flops, nbytes = cost.rglru_scan(B, S, W, 2)
    record = _kernel_record(
        "rglru_scan", "src/repro_torch/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan.py:48",
        lambda: rglru_scan(*args), lambda: rglru_scan_torch(*args), None,
        nbytes=nbytes, flops=flops, peak_flops=HW["peak_flops_fp32"],
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


def _check_rows(res, n_rows):
    if len(res.rows) != n_rows:
        raise AssertionError(f"{len(res.rows)} rows, expected {n_rows}")
    for k in res.keys():
        if not np.isfinite(res.col(k)).all():
            raise AssertionError(f"non-finite {k} in the sweep rows")


def cross_check(dev):
    from repro_torch.cluster.placement import plan_torch
    from repro_torch.launch.sweep_scale import engine, spec
    from repro_torch.workload.azure_like import sample_population_matrix
    demand = sample_population_matrix(5_000, days=1, seed=SEED)
    _, eng = engine(5_000)
    p_gpu = plan_torch(eng, demand, device=dev)
    p_cpu = plan_torch(eng, demand, device="cpu")
    if not (np.array_equal(p_gpu.assign, p_cpu.assign)
            and np.array_equal(p_gpu.migrations, p_cpu.migrations)):
        raise AssertionError("card and CPU plans differ")
    plan_err = max(float(np.abs(p_gpu.overhead_g - p_cpu.overhead_g).max()),
                   float(np.abs(p_gpu.downtime_s - p_cpu.downtime_s).max()))
    r_gpu = spec(demand, eng, dev, layered=False).run()
    r_cpu = spec(demand, eng, "cpu", layered=False).run()
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
    from repro_torch.launch.sweep_scale import engine, spec
    from repro_torch.workload.azure_like import sample_population_matrix
    n_traces = FULL_TRACES
    t0 = time.perf_counter()
    demand = sample_population_matrix(n_traces, days=1, seed=SEED)
    gen_s = time.perf_counter() - t0
    T = demand.shape[0]
    N = n_traces * N_TARGETS
    cap, eng = engine(n_traces)
    R = eng.n_regions

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = plan_torch(eng, demand, device=dev)      # ends in a host copy
    plan_s = time.perf_counter() - t0
    over = int((plan.occupancy() > cap).sum())
    if over:
        raise AssertionError(f"{over} over-capacity region-epochs")

    sweep = spec(demand, eng, dev, layered=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    res = sweep.run()
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
    sweep_prof = _device_profile(sweep.run)
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


# row keys held exactly card against CPU: counts, and counts turned means
LAYERED_EXACT = ("migrations_mean", "placement_migrations_mean",
                 "fault_failed_migrations_mean", "fault_max_age",
                 "elastic_level_epochs", "traffic_replica_epochs",
                 "energy_outage_epochs")
TRAFFIC_BUDGET_G = 16.0     # binds at 2,000 traces: about 3 in 4 replicas
ELASTIC_CHECK_G = 4.0       # g per trace per epoch: 1.12 levels a container
#                             against 1.36 uncapped, on the raw demand


def _sweep_plan(spec, device, timing=None):
    """The plan of a `SweepSpec` on `device`, through the sweep's own
    prologue: grid events on the true feed, the fault plan's degraded
    feed and seeded migration-failure mask. With `timing`,
    ``timing["plan_s"]`` gets the planner's wall time (ended by its host
    copy)."""
    from repro_torch.cluster.placement import plan_torch
    from repro_torch.core.fleet import _prepare_sweep_inputs

    def plan_fn(e, d, flt):
        if timing is not None and str(device) != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = plan_torch(e, d, state_gb=spec.sim.state_gb, faults=flt,
                          device=device)
        if timing is not None:
            timing["plan_s"] = time.perf_counter() - t0
        return plan
    return _prepare_sweep_inputs(
        spec.traces, spec.carbon, spec.targets, spec.sim, spec.demand_scale,
        spec.resolve_placement(), plan_fn, energy=spec.energy,
        faults=spec.faults)[3]


def _rows_exact(a, b, where):
    """Card and CPU rows: the same keys, the counts equal."""
    for x, y in zip(a, b):
        if set(x) != set(y):
            raise AssertionError(f"{where}: row keys differ: "
                                 f"{sorted(set(x) ^ set(y))}")
        for k in LAYERED_EXACT + tuple(k for k in x
                                        if k.endswith("_violations")):
            if k in x and x[k] != y[k]:
                raise AssertionError(f"{where}: {k} {x[k]} on the card, "
                                     f"{y[k]} on the CPU")


def device_arithmetic(dev):
    """What the sweep's exact counts rest on: on 1,000,000 random f64
    values, `devmath.divide`, `ordered_cumsum` and `ordered_sum` give the
    same bits on the card as on the CPU; beside them, how many values of
    the two PyTorch operations they replace (``x / 3600.0``,
    `torch.cumsum`) differ between the card and the CPU. Then the
    greedies' budget cut at the layered sweep's 400,000 entries
    (100,000 traces x 4 levels): `budget_admits` on the card decides as
    NumPy's ``np.cumsum`` does, for a budget between the block order's
    prefix sum and NumPy's (refolded once) and for one far from both."""
    from repro_torch import devmath
    from repro_torch.devmath import (budget_admits, divide, ordered_cumsum,
                                     ordered_sum)
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.random(1_000_000) * 1000.0)
    xg = x.to(dev)

    def differ(f):
        return int((f(x) != f(xg).cpu()).sum())
    out = {"n": x.numel(),
           "divide_differ": differ(lambda t: divide(t, 3600.0)),
           "ordered_cumsum_differ": differ(ordered_cumsum),
           "ordered_sum_differ": differ(lambda t: ordered_sum(t)[None]),
           "host_scalar_div_differ": differ(lambda t: t / 3600.0),
           "torch_cumsum_differ": differ(lambda t: torch.cumsum(t, 0)),
           "torch_sum_differ": differ(lambda t: t.sum()[None])}
    bad = {k: v for k, v in out.items()
           if k in ("divide_differ", "ordered_cumsum_differ",
                    "ordered_sum_differ") and v}
    if bad:
        raise AssertionError(f"card and CPU arithmetic differ: {bad}")

    L = 4 * FULL_TRACES
    mand = np.where(rng.random(L) < 0.3, rng.random(L), 0.0)
    gs = rng.random(L) * rng.choice([1e-3, 1.0, 1e2], L)
    seq = np.cumsum(mand)[-1] + np.cumsum(gs)
    m_t, g_t = torch.as_tensor(mand), torch.as_tensor(gs)
    blk = (ordered_sum(m_t) + ordered_cumsum(g_t)).numpy()
    split = np.flatnonzero(seq != blk)
    k = split[len(split) // 2]
    args = (m_t.to(dev), g_t.to(dev))
    live = torch.ones(L, dtype=torch.bool, device=dev)
    cut = {"n": L, "block_order_differs": int(split.size)}
    for name, budget, refolds in (
            ("near", min(seq[k], blk[k]), 1),
            ("far", _between(seq, gs), 0)):
        before = devmath.refolds
        got = budget_admits(*args, budget, live).cpu().numpy()
        if devmath.refolds - before != refolds:
            raise AssertionError(f"budget cut {name}: "
                                 f"{devmath.refolds - before} refolds")
        if not np.array_equal(got, seq <= budget):
            raise AssertionError(f"budget cut {name}: the card's cut is "
                                 f"not NumPy's")
        cut[f"{name}_ms"] = _median_ms(
            lambda b=budget: budget_admits(*args, b, live), reps=5, warmup=1)
    out["budget_cut"] = cut
    return out


def _between(seq, gs):
    """A budget halfway between two prefix sums at least 50 apart, past
    the middle: far from every prefix sum in either order."""
    j = len(gs) // 2 + int(np.argmax(gs[len(gs) // 2 + 1:] > 50.0))
    return 0.5 * (seq[j] + seq[j + 1])


def _elastic_vs_numpy(demand, plan, ela, dev):
    """The card's elastic levels against the NumPy layer's, whose budget
    cut is ``np.cumsum``'s, on the plan's carbon gathered dense: a cut
    sums n_traces x K entries, past one fixed-order block. The budget
    must lift some containers above their floor level."""
    from repro_torch import devmath
    from repro_torch.core.elasticity import simulate_elastic
    from repro_torch.core.elasticity_torch import simulate_elastic_torch
    T = demand.shape[0]
    dense = plan.region_intensity[np.arange(T)[:, None], plan.assign]
    t0 = time.perf_counter()
    host = simulate_elastic(demand, dense, ela, 300.0)
    numpy_s = time.perf_counter() - t0
    before = devmath.refolds
    card = simulate_elastic_torch(demand, dense, ela, 300.0, record=True,
                                  device=dev)
    if not np.array_equal(card.levels, host.levels):
        raise AssertionError(
            f"elastic levels differ from the NumPy layer's in "
            f"{int((card.levels != host.levels).sum())} container-epochs")
    if not host.levels.size < host.levels.sum():
        raise AssertionError("the elastic budget admits no optional level")
    return {"entries_per_cut": demand.shape[1] * ela.k_levels,
            "level_epochs": int(host.levels.sum()),
            "refolds": devmath.refolds - before, "numpy_s": numpy_s}


def layered_cross_check(dev):
    """Card against CPU with the layers on, at 2,000 traces x 10 targets,
    one day, in jax_sweep_scale's settings (its 1,000,000 users, a budget
    of 2.5 g per trace per epoch, capacity 0.6 of the traces): the plan,
    the traffic replicas (with and without a carbon budget), the elastic
    levels (also against the NumPy layer's on dense carbon) and the
    sweep rows, (a) with all four layers and the fault plan and (b)
    without elasticity, so that the traffic and energy steps
    run folded into the fleet scan on the card. Rows within 1e-6; plans,
    migrations, failed migrations, replica and level counts exactly."""
    import dataclasses

    from repro_torch.core.elasticity_torch import simulate_elastic_torch
    from repro_torch.launch.sweep_scale import engine, layers, spec
    from repro_torch.traffic import request_matrix, simulate_traffic
    from repro_torch.traffic.sim_torch import simulate_traffic_torch
    from repro_torch.workload.azure_like import sample_population_matrix
    n = LAYERED_CROSS_TRACES
    demand = sample_population_matrix(n, days=1, seed=SEED)
    T = demand.shape[0]
    cap, eng = engine(n)
    lay = layers(n)
    p_gpu, p_cpu = (_sweep_plan(spec(demand, eng, d), d) for d in (dev, "cpu"))
    for f in ("assign", "migrations", "failed_migrations"):
        if not np.array_equal(getattr(p_gpu, f), getattr(p_cpu, f)):
            raise AssertionError(f"card and CPU plans differ in {f}")
    plan_err = max(float(np.abs(p_gpu.overhead_g - p_cpu.overhead_g).max()),
                   float(np.abs(p_gpu.downtime_s - p_cpu.downtime_s).max()))
    over = int((p_gpu.occupancy() > cap).sum())
    if plan_err > 1e-9 or over:
        raise AssertionError(f"plan: err {plan_err}, {over} over capacity")
    out = {"n_traces": n, "n_targets": N_TARGETS, "plan_err": plan_err,
           "plan_migrations": int(p_gpu.migrations.sum()),
           "plan_failed_migrations": int(p_gpu.failed_migrations.sum())}

    # replica counts: the sweep's requests routed on the observed feed
    arr = request_matrix(lay["traffic"].population, T, 300.0)
    out["traffic"] = {}
    for budget in (None, TRAFFIC_BUDGET_G):
        cfg = dataclasses.replace(lay["traffic"], replicas=dataclasses.replace(
            lay["traffic"].replicas, budget_g_per_epoch=budget))
        host = simulate_traffic(arr.requests, p_cpu.region_intensity, cfg)
        runs = [simulate_traffic_torch(arr.requests, p_cpu.region_intensity,
                                       cfg, device=d) for d in (dev, "cpu")]
        if not all(np.array_equal(r.replicas, host.replicas) for r in runs):
            raise AssertionError(f"replica counts differ (budget {budget})")
        err = max(float(np.abs(getattr(runs[0], f) - getattr(r, f)).max())
                  / max(float(np.abs(getattr(r, f)).max()), 1.0)
                  for r in (runs[1], host)
                  for f in ("served", "emissions_g", "routed"))
        if err > 1e-6:
            raise AssertionError(f"traffic card vs CPU/host: {err}")
        out["traffic"][str(budget)] = {
            "replica_epochs": int(host.replicas.sum()), "max_rel_err": err}
    if not (out["traffic"][str(TRAFFIC_BUDGET_G)]["replica_epochs"]
            < out["traffic"]["None"]["replica_epochs"]):
        raise AssertionError("the traffic budget does not bind")

    # elastic levels, epoch by epoch: the compact demand on the plan's
    # indexed carbon, under a shaped budget that admits some optional
    # levels and refuses others
    ela = dataclasses.replace(lay["elasticity"],
                              budget_g_per_epoch=ELASTIC_CHECK_G * n)
    runs = [simulate_elastic_torch(demand, (p_cpu.region_intensity,
                                            p_cpu.assign), cfg, 300.0,
                                   record=True, device=d)
            for cfg, d in ((ela, dev), (ela, "cpu"),
                           (dataclasses.replace(ela, budget_g_per_epoch=None,
                                                shape_budget=False), "cpu"))]
    if not np.array_equal(runs[0].levels, runs[1].levels):
        raise AssertionError("card and CPU elastic levels differ")
    s_gpu, s_cpu = runs[0].summary(), runs[1].summary()
    err = max(abs(s_gpu[k] - s_cpu[k]) / max(abs(s_cpu[k]), 1.0)
              for k in s_cpu)
    if err > 1e-6 or s_gpu["elastic_cap_violations"]:
        raise AssertionError(f"elastic summary card vs CPU {err}, "
                             f"{s_gpu['elastic_cap_violations']} violations")
    levels = [int(r.levels.sum()) for r in runs]
    if not n * T < levels[0] < levels[2]:
        raise AssertionError(f"the elastic budget is not selective: level-"
                             f"epochs {levels[0]}, floor {n * T}, uncapped "
                             f"{levels[2]}")
    out["elastic"] = {"level_epochs": levels[0], "uncapped": levels[2],
                      "summary_max_rel_err": err,
                      "vs_numpy": _elastic_vs_numpy(demand, p_cpu, ela, dev)}

    for name, ela in (("a_all_four", True), ("b_folded_in_scan", False)):
        r_gpu = spec(demand, eng, dev, elasticity=ela).run()
        r_cpu = spec(demand, eng, "cpu", elasticity=ela).run()
        _check_rows(r_gpu, N_TARGETS)
        _rows_exact(r_gpu, r_cpu, name)
        parity = r_gpu.parity(r_cpu)
        if parity > 1e-6:
            raise AssertionError(f"{name}: card vs CPU rows {parity}")
        if r_gpu[0]["fault_failed_migrations_mean"] != float(
                np.mean(p_gpu.failed_migrations)):
            raise AssertionError(f"{name}: the sweep's plan differs")
        bad = {k: v for k, v in r_gpu.violations.items()
               if k != "traffic_slo_violations" and v}
        if bad:
            raise AssertionError(f"{name}: violations {bad}")
        out[name] = {"rows_parity": parity,
                     "violations": r_gpu.violations,
                     "row0": {k: v for k, v in r_gpu[0].items()
                              if k != "time_on_slice"}}
    return out


def layered_full_width(dev):
    """`benchmarks/figs.py::jax_sweep_scale` itself: 100,000 traces x 10
    targets = 1,000,000 containers, 288 epochs, all four layers and the
    fault plan, nothing cut. Then its elastic levels against the NumPy
    layer's at 400,000 entries a cut, under the cross-check's budget."""
    import dataclasses

    from repro_torch import devmath
    from repro_torch.launch.sweep_scale import engine, layers, spec
    from repro_torch.workload.azure_like import sample_population_matrix
    n_traces = FULL_TRACES
    t0 = time.perf_counter()
    demand = sample_population_matrix(n_traces, days=1, seed=SEED)
    gen_s = time.perf_counter() - t0
    T = demand.shape[0]
    N = n_traces * N_TARGETS
    cap, eng = engine(n_traces)
    timing = {}
    lay = layers(n_traces)
    plan = _sweep_plan(spec(demand, eng, dev), dev, timing)
    over = int((plan.occupancy() > cap).sum())
    if over:
        raise AssertionError(f"{over} over-capacity region-epochs")

    sweep = spec(demand, eng, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    refolds = devmath.refolds
    t0 = time.perf_counter()
    res = sweep.run()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = _read_counts()
    refolds = devmath.refolds - refolds
    want = {name: 0 for name in launches}
    want["admission_round"] = T                    # one call an epoch
    if launches != want:
        raise AssertionError(f"kernel launches {launches} on the layered "
                             f"sweep, expected {want}")
    _check_rows(res, N_TARGETS)
    row = res[0]
    if (row["placement_migrations_mean"] != float(np.mean(plan.migrations))
            or row["fault_failed_migrations_mean"]
            != float(np.mean(plan.failed_migrations))):
        raise AssertionError("the sweep's plan differs from the one checked")
    for k in ("energy_cap_violations", "energy_soc_violations"):
        if row[k]:
            raise AssertionError(f"{k} = {row[k]}")
    prof = _device_profile(sweep.run)
    host_wall, host = _host_breakdown(sweep.run)
    out = {"n_traces": n_traces, "n_targets": N_TARGETS,
           "n_containers": N, "n_epochs": T, "n_regions": eng.n_regions,
           "capacity": cap, "gen_s": gen_s, "plan_s": timing["plan_s"],
           "sweep_s": sweep_s, "container_epochs_per_s": N * T / sweep_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "over_capacity_epochs": over, "launches": launches,
           "budget_refolds": refolds,
           "elastic_vs_numpy": _elastic_vs_numpy(
               demand, plan, dataclasses.replace(
                   lay["elasticity"],
                   budget_g_per_epoch=ELASTIC_CHECK_G * n_traces), dev),
           "plan_migrations": int(plan.migrations.sum()),
           "plan_failed_migrations": int(plan.failed_migrations.sum()),
           "violations": res.violations,
           "profile": {"sweep": dict(zip(("wall_s", "device_s", "top"),
                                         prof))},
           "host_breakdown": {"wall_s": host_wall, "cumulative_s": host}}
    for k in ("energy_cap_violations", "energy_soc_violations",
              "energy_conservation_max_err_w", "elastic_cap_violations",
              "fault_unmetered_g_mean", "elastic_level_epochs",
              "elastic_served_frac", "traffic_served",
              "traffic_replica_epochs", "energy_solar_frac",
              "energy_unmet_frac", "fault_stale_frac",
              "fault_failed_migrations_mean", "carbon_rate_mean",
              "migrations_mean"):
        out[k] = row[k]
    if prof[1] is not None:
        out["sweep_device_s"] = prof[1]
        out["sweep_device_busy_share"] = prof[1] / sweep_s
    return out


SCENARIO_T, SCENARIO_CROSS_TRACES = 288, 24     # the reference's own shape
SCENARIO_TARGETS = (40.0, 80.0)
SCENARIO_EXACT = ("migrations_mean", "placement_migrations_mean",
                  "fault_failed_migrations_mean", "energy_outage_epochs",
                  "energy_cap_violations", "energy_soc_violations")


def scenario_cross_check(dev):
    """The scenario matrix at the reference's shape (T = 288, 24 traces,
    targets 40 and 80 g/h), `run_matrix(devices=("cuda", "cpu"))`: every
    cell `ok`; rows within PARITY_TOL (expected bit-equal) with the same
    keys and the counts exact; each cell's plan (assignments, moves and
    failed moves) the same on the card as on the CPU."""
    from repro_torch.energy import scenarios as sc
    cells = sc.run_matrix(T=SCENARIO_T, n_tr=SCENARIO_CROSS_TRACES,
                          targets=SCENARIO_TARGETS, devices=(dev, "cpu"))
    out = {}
    for cell in cells:
        card, cpu = cell["results"][dev], cell["results"]["cpu"]
        if not cell["ok"]:
            raise AssertionError(f"scenario {cell['name']}: {cell['checks']}")
        for a, b in zip(card, cpu):
            if set(a) != set(b):
                raise AssertionError(f"scenario {cell['name']}: row keys "
                                     f"differ: {sorted(set(a) ^ set(b))}")
            for k in SCENARIO_EXACT:
                if k in a and a[k] != b[k]:
                    raise AssertionError(f"scenario {cell['name']}: {k} "
                                         f"{a[k]} on the card, {b[k]} on "
                                         f"the CPU")
        plans = [_sweep_plan(card.spec, d) for d in (dev, "cpu")]
        for f in ("assign", "migrations", "failed_migrations"):
            x, y = (getattr(p, f) for p in plans)
            if (x is None) != (y is None) or (
                    x is not None and not np.array_equal(x, y)):
                raise AssertionError(f"scenario {cell['name']}: card and "
                                     f"CPU plans differ in {f}")
        out[cell["name"]] = {
            "checks": cell["checks"], "rows_equal": card.rows == cpu.rows,
            "meta": {k: v for k, v in cell["meta"].items()
                     if k != "episodes"},
            "plan_migrations": int(plans[0].migrations.sum()),
            "sweep_s": cell["sweep_s"][dev], "cpu_sweep_s": cell["sweep_s"][
                "cpu"]}
    return {"n_traces": SCENARIO_CROSS_TRACES, "n_epochs": SCENARIO_T,
            "targets": list(SCENARIO_TARGETS),
            "max_parity": max(c["checks"]["backend_parity"]
                              for c in out.values()),
            "cells": out}


def scenario_full_width(dev):
    """Every cell of the scenario matrix at 100,000 traces (the trace count
    of jax_sweep_scale): 2 policies x 2 targets x 100,000 = 400,000
    containers over 288 epochs, the energy step folded into the fleet
    scan on the card. Each cell is a main path: T admission launches (one
    planned sweep), no other kernel; conservation <= 1e-6 W, no cap or
    state-of-charge violation. Then the device busy share of one cell
    and its host time by stage (cProfile)."""
    from repro_torch.energy import scenarios as sc
    n_tr, T = FULL_TRACES, SCENARIO_T
    n = 2 * len(SCENARIO_TARGETS) * n_tr
    cells, launches = {}, {}
    for cell in sc.build_matrix(T):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        t0 = time.perf_counter()
        out = sc.run_scenario(cell, T=T, n_tr=n_tr, targets=SCENARIO_TARGETS,
                              devices=(dev,))
        total_s = time.perf_counter() - t0
        counts = _read_counts()
        want = {name: 0 for name in counts}
        want["admission_round"] = T
        if counts != want:
            raise AssertionError(f"scenario {cell.name}: kernel launches "
                                 f"{counts}, expected {want}")
        if not out["ok"]:
            raise AssertionError(f"scenario {cell.name}: {out['checks']}")
        res = out["results"][dev]
        _check_rows(res, len(res.rows))
        sweep_s = out["sweep_s"][dev]
        rec = {"sweep_s": sweep_s, "setup_s": total_s - sweep_s,
               "container_epochs_per_s": n * T / sweep_s,
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
               "admission_launches": counts["admission_round"],
               "energy_unmet_frac": out["unmet_frac"],
               "outage_epochs": out["outage_epochs"], **out["checks"]}
        cells[cell.name] = rec
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        print(f"[scenario {cell.name}] " + json.dumps(rec), flush=True)
        del out, res
        gc.collect()
    # where the time goes in one cell, after the counted runs
    prof = {}
    cell = sc.build_matrix(T)[0]
    wall, dev_s, top = _device_profile(lambda: prof.update(sc.run_scenario(
        cell, T=T, n_tr=n_tr, targets=SCENARIO_TARGETS, devices=(dev,))))
    profile = {"cell": cell.name, "wall_s": wall, "device_s": dev_s,
               "sweep_s": prof["sweep_s"][dev], "top": top}
    if dev_s is not None:
        profile["device_busy_share"] = dev_s / prof["sweep_s"][dev]
    host_wall, host = _host_breakdown(lambda: sc.run_scenario(
        cell, T=T, n_tr=n_tr, targets=SCENARIO_TARGETS, devices=(dev,)))
    profile["host_breakdown"] = {"wall_s": host_wall, "cumulative_s": host}
    return {"n_traces": n_tr, "n_containers": n, "n_epochs": T,
            "targets": list(SCENARIO_TARGETS), "cells": cells,
            "launches": launches, "profile": profile}


CUSTOM_TRACES = 2_000


def custom_policy(dev):
    """A subclass of a stock policy defeats the fleet's exact-type
    dispatch, so its own `decide_batch` runs on the host once an epoch:
    2,000 traces x 1 target x 288 epochs on the card, placed; its rows
    within 1e-9 of the stock kernel's, counts exact. A subclassed
    CarbonAgnosticPolicy (the main path; its admission launches are
    counted) and a subclassed CarbonContainerPolicy (whose decisions
    read the state)."""
    from repro_torch.cluster.slices import paper_family
    from repro_torch.core.policy import (CarbonAgnosticPolicy,
                                         CarbonContainerPolicy)
    from repro_torch.core.spec import SweepSpec
    from repro_torch.launch.sweep_scale import engine
    from repro_torch.workload.azure_like import sample_population_matrix
    demand = sample_population_matrix(CUSTOM_TRACES, days=1, seed=SEED)
    _, eng = engine(CUSTOM_TRACES)
    out = {"n_traces": CUSTOM_TRACES, "targets": [45.0]}
    for name, stock in (("agnostic", CarbonAgnosticPolicy),
                        ("cc_energy", CarbonContainerPolicy)):
        custom = type(f"Custom{stock.__name__}", (stock,), {})
        runs = {}
        for kind, pol in (("custom", custom), ("stock", stock)):
            spec = SweepSpec(policies={"x": pol}, family=paper_family(),
                             traces=demand, targets=[45.0], placement=eng,
                             device=dev)
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            runs[kind] = spec.run()
            torch.cuda.synchronize()
            runs[kind + "_s"] = time.perf_counter() - t0
            runs[kind + "_launches"] = _read_counts()
        want = {k: 0 for k in runs["custom_launches"]}
        want["admission_round"] = SCENARIO_T
        if runs["custom_launches"] != want:
            raise AssertionError(f"custom {name}: launches "
                                 f"{runs['custom_launches']}, expected "
                                 f"{want}")
        parity = runs["custom"].parity(runs["stock"])
        a, b = runs["custom"][0], runs["stock"][0]
        if parity > 1e-9 or any(a[k] != b[k] for k in (
                "migrations_mean", "placement_migrations_mean")):
            raise AssertionError(f"custom {name} vs the stock kernel: rows "
                                 f"{parity}")
        out[name] = {"parity_vs_stock": parity, "custom_s": runs["custom_s"],
                     "stock_s": runs["stock_s"],
                     "migrations_mean": a["migrations_mean"],
                     "carbon_rate_mean": a["carbon_rate_mean"]}
        if name == "agnostic":
            out["launches"] = runs["custom_launches"]
    return out


def carbon_serve(engine, dev):
    """`repro_torch.launch.carbon_serve` on a loaded engine: the decode
    capacity calibrated on the card as its `main` does, the 96-interval
    control loop, then the duty it chose (its smallest in (0, 1), else
    0.5) applied to `generate` of 8 tokens: the decode loop's wall time
    over its device-synced step time must be 1/duty within 10 %. Every
    flash launch of the path (the two prefills) is on the wgmma route."""
    from collections import Counter

    from repro_torch.launch.carbon_serve import (TARGET_G_PER_H, calibrate,
                                                 control_loop, summary)
    _zero_counts()
    t0 = time.perf_counter()
    tok_s = calibrate(engine)
    calibrate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    records, sch = control_loop(tok_s)
    loop_s = time.perf_counter() - t0
    s = summary(records, sch)
    duties = [r["duty"] for r in records if 0.0 < r["duty"] < 1.0]
    duty = min(duties) if duties else 0.5
    prompts = np.zeros((4, 8), np.int32)
    engine.stats = dict.fromkeys(engine.stats, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(prompts, 8, duty=duty)
    wall = time.perf_counter() - t0
    decode_wall = wall - engine.stats["prefill_s"]
    ratio = decode_wall / engine.stats["decode_s"]
    launches, routes = _read_counts(), _read_routes()
    n_layers = engine.model.cfg.n_layers
    want = {name: 0 for name in launches}
    want["flash_attention"] = 2 * n_layers          # two prefills
    if launches != want or routes["flash_attention"].get(
            "wgmma", 0) != want["flash_attention"]:
        raise AssertionError(f"carbon serve: launches {launches}, routes "
                             f"{routes}; expected {want} on wgmma")
    if not abs(ratio * duty - 1.0) <= 0.10:
        raise AssertionError(f"carbon serve: at duty {duty} the decode "
                             f"loop took {ratio} x its step time, not "
                             f"1/duty = {1.0 / duty} within 10 %")
    if len(records) != 96 or not np.isfinite(s["avg_rate"]):
        raise AssertionError(f"carbon serve: {len(records)} records, "
                             f"avg C(t) {s['avg_rate']}")
    return {"arch": engine.model.cfg.name, "tok_s": tok_s,
            "calibrate_s": calibrate_s, "loop_s": loop_s,
            "avg_rate_g_per_h": s["avg_rate"], "target_g_per_h":
            TARGET_G_PER_H, "served": s["n"], "p50_s": s["p50_s"],
            "p95_s": s["p95_s"],
            "kinds": dict(Counter(r["kind"] for r in records)),
            "slices": dict(Counter(r["slice"] for r in records)),
            "duty_check": {"duty": duty, "new_tokens": 8,
                           "decode_wall_s": decode_wall,
                           "decode_s": engine.stats["decode_s"],
                           "wall_over_step": ratio,
                           "expected": 1.0 / duty},
            "launches": launches, "route_launches": routes}


# ---------------------------------------------------------------------------
# Training (SmolLM-135M): flash under autograd, card vs CPU, full width,
# the carbon-aware trainer
# ---------------------------------------------------------------------------

TRAIN_ARCH = "smollm-135m"
# the reference's train_4k shape: 4,096 x 256 tokens a step, microbatches
# of 8 sequences, bf16 activations, f32 masters, AdamW, no remat
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 4096, 256, 8
# B, S, Hq, Hkv, Dh, causal, window: tests/test_kernels.py's self-attention
# cases in float32, then SmolLM-135M's training microbatch in bf16
FLASH_TRAIN_F32 = [(2, 128, 4, 2, 32, True, 0), (1, 64, 2, 1, 16, True, 24),
                   (2, 128, 4, 4, 64, False, 0), (1, 96, 8, 2, 32, True, 0)]
FLASH_TRAIN_MAIN = (TRAIN_MICRO, TRAIN_SEQ, 9, 3, 64, True, 0)
# SmolLM-135M's 512-token training microbatch (portbench's train-512 cell)
FLASH_TRAIN_512 = (64, 512, 9, 3, 64, True, 0)
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
UPDATE_OFF_SHARE = 1e-4     # train card vs CPU: updates allowed off the bar
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the bf16 backward kernel against the plain f32 backward on the same
# inputs, of each gradient's max |g|: both round their outputs to bf16,
# the kernel P and dS too before their products
BWD_PLAIN_TOL = 1.5e-2
# the carbon-aware trainer's scenario (tests/test_torch_trainer.py
# "duty_suspend"): hourly g/kWh, target g/h, simulated s a step, steps
TRAINER_TRACE = [400.0, 800.0, 2000.0, 100.0] * 12
# 6 steps: 4 at duty 0.35 with a migration after the second, a suspend
# of 12 intervals, the resume and one step after it
TRAINER_TARGET, TRAINER_SIM_STEP_S, TRAINER_STEPS = 40.0, 600.0, 6


def _train_qkvd(case, dtype, dev, seed):
    B, S, Hq, Hkv, Dh = case[:5]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(B, S, h, Dh, generator=gen, device=dev).to(dtype)
                 for h in (Hq, Hkv, Hkv, Hq))


def _hold_backward_kernel(q, k, v, out, lse, dout, causal, window) -> dict:
    """The backward kernel's (dq, dk, dv) against the plain backward's on
    the same bf16 inputs, within BWD_PLAIN_TOL of each one's max |g|,
    and a second call bit-equal to the first."""
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.kernels.ref import flash_bwd_torch
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                   window=window)
    again = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                     window=window)
    plain = flash_bwd_torch(q, k, v, out, lse, dout, causal, window,
                            q.shape[3] ** -0.5)
    torch.cuda.synchronize()
    rel = [float((g.float() - p.float()).abs().max() / p.float().abs().max())
           for g, p in zip(got, plain)]
    same = all(torch.equal(a, g) for a, g in zip(again, got))
    if flash_attention_backward.launches != before + 2 or not same or max(
            rel) > BWD_PLAIN_TOL:
        raise AssertionError(f"backward kernel at {tuple(q.shape)}: dq, dk, "
                             f"dv err / max|g| against the plain version "
                             f"{rel}, a second call bit-equal {same}")
    return {"err_over_max_vs_plain": rel, "tol": BWD_PLAIN_TOL,
            "second_call_bit_equal": same}


def flash_train_phase(dev):
    """Flash attention under autograd (`FlashAttentionFn`): for
    tests/test_kernels.py's float32 cases and SmolLM-135M's training
    microbatch (8 x 4,096, 9:3 heads of 64) in bf16, the kernel's
    log-sum-exp against `_flash_fwd_inner`'s (`ref.flash_fwd_torch`),
    out against the plain version at the flash bars, dq / dk / dv
    against autograd through `attention_ref` (1e-4 / 2e-2 of max |g|);
    then at the training shape the times of the forward with lse, of
    the backward (the bf16 kernel of `flash_attention_backward`, and the
    plain version: torch in float32, the reference's `_flash_bwd_inner`),
    and of SDPA forward + backward; and the two backwards' times at the
    512-token microbatch too. At both microbatches the kernel's dq, dk,
    dv are held to the plain backward's on the same inputs within
    BWD_PLAIN_TOL of each one's max |g| (test_torch_cuda.py's bar), and
    a second call gives the same bits (dq's fixed-order sum)."""
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn, backward_route, flash_attention,
        flash_attention_backward, route)
    from repro_torch.kernels.ref import (attention_ref, flash_bwd_torch,
                                         flash_fwd_torch)
    from repro_torch.launch.dryrun_lib import HW
    checked = []
    runs = [(c, torch.float32) for c in FLASH_TRAIN_F32]
    runs.append((FLASH_TRAIN_MAIN, torch.bfloat16))
    for i, (case, dtype) in enumerate(runs):
        B, S, Hq, Hkv, Dh, causal, window = case
        q, k, v, dout = _train_qkvd(case, dtype, dev, seed=100 + i)
        with torch.no_grad():
            out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
            want_out = attention_ref(q, k, v, causal=causal, window=window)
            want_lse = flash_fwd_torch(q, k, v, causal, window)[1]
        torch.cuda.synchronize()
        lse_err = float((lse - want_lse).abs().max())
        out_err = float((out.float() - want_out.float()).abs().max())
        tol = FLASH_TOL[dtype]
        if lse_err > LSE_TOL[dtype] or not torch.allclose(
                out.float(), want_out.float(), atol=tol, rtol=tol):
            raise AssertionError(f"flash with lse at {case} {dtype}: lse "
                                 f"max abs {lse_err}, out max abs {out_err}")
        del out, lse, want_out, want_lse
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(FlashAttentionFn.apply(
            *leaves, causal, window, None), leaves, dout)
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(attention_ref(
            *ref_leaves, causal=causal, window=window), ref_leaves, dout)
        torch.cuda.synchronize()
        rel = [float((g.float() - w.float()).abs().max()
                     / w.float().abs().max()) for g, w in zip(got, want)]
        if max(rel) > GRAD_TOL[dtype]:
            raise AssertionError(f"FlashAttentionFn grads at {case} {dtype}:"
                                 f" dq, dk, dv err / max|g| {rel}")
        checked.append({"case": list(case), "dtype": str(dtype)[6:],
                        "route": route(dtype, Dh) + "+lse",
                        "backward_route": backward_route(dtype, Dh),
                        "lse_max_abs_err": lse_err,
                        "lse_tol": LSE_TOL[dtype], "out_max_abs_err": out_err,
                        "out_tol": tol, "grad_err_over_max": rel,
                        "grad_tol": GRAD_TOL[dtype]})
        del got, want, leaves, ref_leaves
        _free_device_memory()

    # times at the training shape
    B, S, Hq, Hkv, Dh, causal, window = FLASH_TRAIN_MAIN
    q, k, v, dout = _train_qkvd(FLASH_TRAIN_MAIN, torch.bfloat16, dev, 7)
    scale = Dh ** -0.5
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    fwd_lse_ms = _median_ms(lambda: flash_attention(
        q, k, v, causal=causal, return_lse=True), head_start_cycles=2_000_000)
    fwd_ms = _median_ms(lambda: flash_attention(q, k, v, causal=causal),
                        head_start_cycles=2_000_000)
    bwd_ms = _median_ms(lambda: flash_bwd_torch(
        q, k, v, out, lse, dout, causal, window, scale), reps=10,
        head_start_cycles=20_000_000)
    held_4k = _hold_backward_kernel(q, k, v, out, lse, dout, causal, window)
    before = flash_attention_backward.launches
    bwd_kernel_ms = _median_ms(lambda: flash_attention_backward(
        q, k, v, out, lse, dout, causal=causal, window=window, scale=scale),
        head_start_cycles=2_000_000)
    if flash_attention_backward.launches == before:
        raise AssertionError("the backward kernel was not launched at the "
                             "training shape")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def ours():
        torch.autograd.grad(FlashAttentionFn.apply(
            *leaves, causal, window, None), leaves, dout)
    tl = [t.transpose(1, 2).detach().clone().requires_grad_()
          for t in (q, k, v)]
    dout_t = dout.transpose(1, 2)

    def sdpa():
        torch.autograd.grad(F.scaled_dot_product_attention(
            *tl, is_causal=causal, enable_gqa=True), tl, dout_t)
    fwd_bwd_ms = _median_ms(ours, reps=10, head_start_cycles=20_000_000)
    sdpa_fwd_bwd_ms = _median_ms(sdpa, head_start_cycles=2_000_000)
    with torch.no_grad():
        sdpa_fwd_ms = _median_ms(lambda: F.scaled_dot_product_attention(
            *tl, is_causal=causal, enable_gqa=True),
            head_start_cycles=2_000_000)
    fwd_flops, fwd_bytes = cost.flash_attention(B, S, S, Hq, Hkv, Dh, 2,
                                                causal, window, lse=True)
    bwd_flops, bwd_bytes = cost.attention_backward(B, S, S, Hq, Hkv, Dh, 2,
                                                   causal, window)
    del q, k, v, dout, out, lse, leaves, tl, dout_t
    _free_device_memory()
    # the two backwards at the 512-token microbatch
    B5, S5, Hq5, Hkv5, Dh5, causal5, window5 = FLASH_TRAIN_512
    q, k, v, dout = _train_qkvd(FLASH_TRAIN_512, torch.bfloat16, dev, 8)
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, causal=causal5, return_lse=True)
    bwd_512 = {
        "held": _hold_backward_kernel(q, k, v, out, lse, dout, causal5,
                                      window5),
        "kernel_ms": _median_ms(lambda: flash_attention_backward(
            q, k, v, out, lse, dout, causal=causal5, window=window5),
            head_start_cycles=2_000_000),
        "plain_ms": _median_ms(lambda: flash_bwd_torch(
            q, k, v, out, lse, dout, causal5, window5, Dh5 ** -0.5),
            reps=10, head_start_cycles=2_000_000)}
    f5, b5 = cost.attention_backward(B5, S5, S5, Hq5, Hkv5, Dh5, 2, causal5,
                                     window5)
    bwd_512["bound_ms"] = max(
        b5 / HW["hbm_bw"], cost.ATTENTION_BACKWARD_BOUND_SHARE * f5
        / HW["peak_flops_bf16"]) * 1e3
    del q, k, v, dout, out, lse
    _free_device_memory()
    return {"checked": checked, "shape": {
        "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "Dh": Dh, "dtype": "bfloat16",
        "causal": causal, "window": window},
        "kernel_route": route(torch.bfloat16, Dh) + "+lse",
        "fwd_lse_ms": fwd_lse_ms, "fwd_ms": fwd_ms,
        "fwd_lse_bound_ms": max(fwd_bytes / HW["hbm_bw"],
                                fwd_flops / HW["peak_flops_bf16"]) * 1e3,
        "bwd_kernel_ms": bwd_kernel_ms, "bwd_ms": bwd_ms,
        "bwd_held": held_4k, "bwd_flops": bwd_flops,
        "bwd_bound_ms": max(bwd_bytes / HW["hbm_bw"],
                            cost.ATTENTION_BACKWARD_BOUND_SHARE * bwd_flops
                            / HW["peak_flops_bf16"]) * 1e3,
        "bwd_bound_by": "bf16 operations of the dv, dp, dq and dk products "
                        "(989 TFLOP/s; the recomputed scores not counted)",
        "bwd_512": bwd_512,
        "fwd_bwd_ms": fwd_bwd_ms, "sdpa_fwd_ms": sdpa_fwd_ms,
        "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms,
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True), forward + backward"}


def carbon_trainer(dev):
    """`CarbonAwareTrainer` on SmolLM-135M at full width (sequence 4,096,
    global batch 8), on tests/test_torch_trainer.py's "duty_suspend"
    scenario (virtual clock, the reference test's two slices, both on
    this card): at least one interval with a duty below 1, one
    migration and one suspend/resume; every restore bit-equal to the
    state it saved; every step's loss equal to an uninterrupted job's
    on the same batches (expected bit-equal, as every kernel of the step
    is deterministic, the attention backward's dq sum included; the bar
    1e-6 relative); average C(t) <= 1.1 x target (the reference test's
    bar); every attention's backward on the backward kernel."""
    import tempfile

    from repro_torch.carbon.intensity import TraceProvider
    from repro_torch.cluster.slices import Slice, SliceFamily
    from repro_torch.config import CarbonConfig, OptimizerConfig, TrainConfig
    from repro_torch.core.carbon_aware_trainer import CarbonAwareTrainer
    from repro_torch.core.elastic import ElasticJob
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.params import flatten
    from repro_torch.power.model import LinearPowerModel
    model = _family_model(TRAIN_ARCH)
    tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_MICRO,
                       optimizer=OptimizerConfig(warmup_steps=1,
                                                 total_steps=100))
    restores = []

    class RecordingJob(ElasticJob):
        """Holds each restored state against the one it checkpointed."""

        def checkpoint(self):
            self.saved = {p: t.detach().cpu().clone()
                          for p, t in flatten(self.state)}
            return super().checkpoint()

        def _held(self, kind, rec):
            now = dict(flatten(self.state))
            same = set(now) == set(self.saved) and all(
                now[p].dtype == self.saved[p].dtype
                and torch.equal(now[p].cpu(), self.saved[p]) for p in now)
            restores.append({"kind": kind, "bit_equal": same, **rec})
            if not same:
                raise AssertionError(f"trainer: the state after {kind} is "
                                     f"not the one saved")
            return rec

        def migrate(self, devices):
            return self._held("migrate", super().migrate(devices))

        def resume(self, devices):
            return self._held("resume", super().resume(devices))

    slices = [Slice("s1", 0.5, LinearPowerModel(30.0, 80.0), chips=1),
              Slice("s2", 1.0, LinearPowerModel(60.0, 160.0), chips=1)]
    step_tokens = TRAIN_SEQ * TRAIN_MICRO
    step_flops = 6.0 * model.param_count() * step_tokens
    losses = []
    with tempfile.TemporaryDirectory() as d:
        job = RecordingJob(model, tcfg, d)
        job.start([dev], seed=SEED)
        trainer = CarbonAwareTrainer(
            job=job, family=SliceFamily(slices, baseline_idx=1),
            slice_devices=[[dev], [dev]], carbon=TraceProvider(TRAINER_TRACE),
            cfg=CarbonConfig(target_rate=TRAINER_TARGET, interval_s=300.0),
            step_flops=step_flops, step_tokens=step_tokens,
            peak_flops_per_chip=step_flops / 120.0,
            sim_seconds_per_step=TRAINER_SIM_STEP_S)
        _zero_counts()
        t0 = time.perf_counter()
        out = trainer.run(iter(SyntheticLM(model.cfg.vocab_size, TRAIN_SEQ,
                                           TRAIN_MICRO, seed=SEED)),
                          TRAINER_STEPS,
                          on_interval=lambda log, m: losses.append(m["loss"]))
        run_s = time.perf_counter() - t0
        launches, routes = _read_counts(), _read_routes()
        del job, trainer
        _free_device_memory()
    with tempfile.TemporaryDirectory() as d:
        twin = ElasticJob(model, tcfg, d)
        twin.start([dev], seed=SEED)
        data = iter(SyntheticLM(model.cfg.vocab_size, TRAIN_SEQ, TRAIN_MICRO,
                                seed=SEED))
        twin_losses = [twin.train_step(next(data))["loss"]
                       for _ in range(TRAINER_STEPS)]
        del twin
        _free_device_memory()
    logs = out["logs"]
    rates = [x.carbon_rate for x in logs]
    avg = sum(rates) / len(rates)
    kinds = [x.action for x in logs]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, twin_losses))
    per_step = model.cfg.n_layers
    problems = []
    if out["steps"] != TRAINER_STEPS or len(losses) != TRAINER_STEPS:
        problems.append(f"{out['steps']} steps, {len(losses)} losses")
    if not out["migrations"] or "suspend" not in kinds or (
            "resume" not in kinds) or not any(
            x.duty < 1.0 and not x.suspended for x in logs):
        problems.append(f"actions {kinds}")
    if not all(r["bit_equal"] for r in restores) or len(restores) < 2:
        problems.append(f"restores {restores}")
    if loss_err > 1e-6:
        problems.append(f"losses differ from the uninterrupted job's by "
                        f"{loss_err}")
    if avg > 1.1 * TRAINER_TARGET:
        problems.append(f"average C(t) {avg} > 1.1 x {TRAINER_TARGET}")
    if launches["flash_attention"] != TRAINER_STEPS * per_step or routes[
            "flash_attention"]["wgmma+lse"] != TRAINER_STEPS * per_step or (
            launches["flash_attention_bwd"] != TRAINER_STEPS * per_step):
        problems.append(f"launches {launches}, routes {routes}")
    if problems:
        raise AssertionError(f"carbon-aware trainer: {problems}")
    return {"arch": TRAIN_ARCH, "seq_len": TRAIN_SEQ,
            "global_batch": TRAIN_MICRO, "steps": out["steps"],
            "run_s": run_s, "target_g_per_h": TRAINER_TARGET,
            "avg_rate_g_per_h": avg,
            "intervals": [{"t": x.t, "c": x.carbon_intensity,
                           "slice": x.slice_name, "duty": x.duty,
                           "suspended": x.suspended, "action": x.action,
                           "rate": x.carbon_rate} for x in logs],
            "migrations": out["migrations"], "restores": restores,
            "losses": losses, "twin_losses": twin_losses,
            "losses_bit_equal": losses == twin_losses,
            "loss_max_rel_err": loss_err, "launches": launches,
            "route_launches": routes}


# ---------------------------------------------------------------------------
# Training of the Mamba-2, RecurrentGemma and Whisper families
# ---------------------------------------------------------------------------

# SSDScanFn: tests/test_kernels.py's SSD cases in float32, then Mamba-2
# smoke's mixer shape (d_inner 128 = 4 heads of 32, N 16, chunk 16) in bf16
SSD_GRAD_CASES = [((2, 64, 4, 16, 32, 16), torch.float32),
                  ((1, 128, 8, 32, 64, 32), torch.float32),
                  ((2, 96, 4, 64, 16, 32), torch.float32),
                  ((2, 64, 4, 32, 16, 16), torch.bfloat16)]
SCAN_GRAD_TOL = 1e-5    # of max |g|, against autograd through the plain form
# the full-width training microbatches: Mamba-2 (2, 4,096, 80 x 64, N 128,
# chunk 256) and RecurrentGemma's scan (2, 4,096, 4,096), a in bf16
SSD_TRAIN = (2, 4096, 80, 64, 128, 256)
RGLRU_TRAIN = (2, 4096, 4096)
# RGLRUScanFn: the reverse scan bit-equal on the ring route; f32 gradients
# against autograd through `rglru_ref` (a Python loop: short sequences)
RGLRU_GRAD_CASES = [(2, 64, 128), (1, 128, 256), (3, 32, 512)]


def _grad_err(got, want):
    """max over the gradients of max |g - w| / max |w|."""
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max()) for g, w in zip(got, want))


def scan_backward_phase(dev):
    """The SSD and RG-LRU kernels under autograd. `SSDScanFn`: one kernel
    launch on the dtype's route and y at the kernel's bars (the kernel
    checks); its six gradients (with a gradient of h_final) within
    SCAN_GRAD_TOL of max |g| of autograd through `ssd_chunked` on the
    same inputs, which holds by construction (the backward recomputes
    `ssd_chunked` from the saved inputs and never reads the kernel's y):
    it checks the Function's wiring, not the kernel.
    `RGLRUScanFn`: the backward's reverse scan on the ring route and its
    (da, dgx, dh0) bit-equal to `rglru_scan_bwd_torch` (the plain reverse
    loop), at tests/test_kernels.py's cases in both dtypes of a and at
    the training shape; in float32 `rglru_gated`'s gradients within
    SCAN_GRAD_TOL of autograd through `rglru_ref`. Then each backward
    timed at the full-width training microbatch beside its bound: the
    SSD's (plain torch, float32: the recompute and autodiff of
    `ssd_chunked`) and the RG-LRU's (the ring kernel on the reversed
    recurrence and the elementwise products)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.ref import (rglru_ref, rglru_scan_bwd_torch,
                                         ssd_chunked, ssd_chunked_bwd_torch)
    from repro_torch.launch.dryrun_lib import HW
    from repro_torch.kernels.rglru_scan import (RGLRUScanFn, rglru_gated,
                                                rglru_scan, route)
    from repro_torch.kernels.ssd_scan import ROUTES, SSDScanFn, ssd_scan
    ssd_checked = []
    for i, (case, dtype) in enumerate(SSD_GRAD_CASES):
        B, S, H, P, N, Q = case
        args = _ssd_inputs(case, dtype, dev, seed=300 + i)
        gen = torch.Generator(device=dev).manual_seed(i)
        dy = torch.randn(B, S, H, P, generator=gen, device=dev).to(dtype)
        dh = torch.randn(B, H, P, N, generator=gen, device=dev)
        path = ROUTES[dtype]
        before = ssd_scan.route_launches[path]
        leaves = [t.clone().requires_grad_() for t in args]
        y, h = SSDScanFn.apply(*leaves, Q)
        got = torch.autograd.grad([y, h], leaves, [dy, dh])
        plain = [t.clone().requires_grad_() for t in args]
        py, ph = ssd_chunked(*plain, chunk=Q)
        want = torch.autograd.grad([py, ph], plain, [dy, dh])
        torch.cuda.synchronize()
        err = _grad_err(got, want)
        y, py = y.detach(), py.detach()
        y_err = float((y.float() - py.float()).abs().max())
        tol = SSD_TOL[dtype]
        if (ssd_scan.route_launches[path] != before + 1 or err > SCAN_GRAD_TOL
                or not torch.allclose(y.float(), py.float(), atol=tol,
                                      rtol=tol)
                or not all(bool(torch.isfinite(g).all()) for g in got)):
            raise AssertionError(f"SSDScanFn at {case} {dtype}: grads err / "
                                 f"max {err}, y max abs {y_err}")
        ssd_checked.append({"case": list(case), "dtype": str(dtype)[6:],
                            "route": path, "y_max_abs_err": y_err,
                            "grad_err_over_max": err,
                            "grad_check": "the plain backward's by "
                                          "construction: the Function's "
                                          "wiring, not the kernel"})
    rg_checked = []
    runs = [(c, dt) for c in RGLRU_CASES for dt in RGLRU_TOL]
    runs.append((RGLRU_TRAIN, torch.bfloat16))
    for i, (case, dtype) in enumerate(runs):
        B, S, W = case
        a, gx, h0 = _rglru_inputs(case, dtype, dev, seed=400 + i)
        gen = torch.Generator(device=dev).manual_seed(i)
        dy = torch.randn(B, S, W, generator=gen, device=dev)
        dl = torch.randn(B, W, generator=gen, device=dev)
        path = route(a, gx)
        before = rglru_scan.route_launches[path]
        leaves = [t.clone().requires_grad_() for t in (a, gx, h0)]
        hs, hl = RGLRUScanFn.apply(*leaves)
        got = torch.autograd.grad([hs, hl], leaves, [dy, dl])
        want = rglru_scan_bwd_torch(a, hs.detach(), h0, dy, dl)
        torch.cuda.synchronize()
        launched = rglru_scan.route_launches[path] - before
        if path == "ring":
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            err = 0.0 if ok else _grad_err(got, want)
        else:
            err = _grad_err(got, want)
            ok = err <= SCAN_GRAD_TOL
        if not ok or launched != 2:
            raise AssertionError(f"RGLRUScanFn ({path}) at {case} {dtype}: "
                                 f"backward vs the plain reverse loop {err}, "
                                 f"{launched} launches")
        rec = {"case": list(case), "dtype": str(dtype)[6:], "route": path,
               "bit_equal": path == "ring", "err_over_max": err}
        if dtype == torch.float32 and tuple(case) in RGLRU_GRAD_CASES:
            x, r, ig = (torch.randn(B, S, W, generator=gen, device=dev)
                        for _ in range(3))
            lam = torch.randn(W, generator=gen, device=dev)
            leaves = [t.clone().requires_grad_() for t in (x, r, ig, lam, h0)]
            got = torch.autograd.grad(rglru_gated(*leaves[:4], h0=leaves[4]),
                                      leaves, [dy, dl])
            plain = [t.clone().requires_grad_() for t in (x, r, ig, lam, h0)]
            want = torch.autograd.grad(rglru_ref(*plain[:4], h0=plain[4]),
                                       plain, [dy, dl])
            rec["gated_grad_err_over_max"] = _grad_err(got, want)
            if rec["gated_grad_err_over_max"] > SCAN_GRAD_TOL:
                raise AssertionError(f"rglru_gated grads at {case}: {rec}")
        rg_checked.append(rec)
        del leaves, got, want
    if rg_checked[-1]["route"] != "ring":
        raise AssertionError("the training shape is not on the ring route")
    _free_device_memory()

    # the SSD backward at Mamba-2's training microbatch
    B, S, H, P, N, Q = SSD_TRAIN
    args = _ssd_inputs(SSD_TRAIN, torch.bfloat16, dev, seed=500)
    gen = torch.Generator(device=dev).manual_seed(5)
    dy = torch.randn(B, S, H, P, generator=gen, device=dev).to(torch.bfloat16)
    ssd_bwd_ms = _median_ms(lambda: ssd_chunked_bwd_torch(*args, dy,
                                                          chunk=Q),
                            reps=5, warmup=2, head_start_cycles=50_000_000)
    ssd_flops, ssd_bytes = cost.ssd_backward(B, S, H, P, N, Q, 2)
    ssd_bwd = {"shape": {"B": B, "S": S, "H": H, "P": P, "N": N, "chunk": Q,
                         "dtype": "bfloat16"},
               "implementation": "plain torch, float32: kernels/ref.py "
                                 "ssd_chunked_bwd_torch (no kernel; the "
                                 "reference differentiates ssd_chunked)",
               "ms": ssd_bwd_ms, "bytes": ssd_bytes, "flops": ssd_flops,
               "bound_ms": max(ssd_bytes / HW["hbm_bw"],
                               ssd_flops / HW["peak_flops_fp32"]) * 1e3,
               "bound_by": "float32 operations (67 TFLOP/s, no TF32)",
               "library_ms": None, "checked": ssd_checked}
    del args, dy
    _free_device_memory()

    # the RG-LRU backward at RecurrentGemma's training microbatch
    B, S, W = RGLRU_TRAIN
    a, gx, h0 = _rglru_inputs(RGLRU_TRAIN, torch.bfloat16, dev, seed=600)
    dy = torch.randn(B, S, W, generator=gen, device=dev)
    dl = torch.zeros(B, W, device=dev)
    leaves = [t.clone().requires_grad_() for t in (a, gx, h0)]
    hs, hl = RGLRUScanFn.apply(*leaves)

    def backward():
        torch.autograd.grad([hs, hl], leaves, [dy, dl], retain_graph=True)
    before = rglru_scan.route_launches["ring"]
    backward()
    torch.cuda.synchronize()
    if rglru_scan.route_launches["ring"] != before + 1:
        raise AssertionError("the RG-LRU backward did not launch the ring "
                             "kernel")
    rg_bwd_ms = _median_ms(backward, reps=20, head_start_cycles=4_000_000)
    rg_plain_ms = _median_ms(lambda: rglru_scan_bwd_torch(
        a, hs.detach(), h0, dy, dl), reps=3, warmup=1,
        head_start_cycles=400_000_000)
    rg_flops, rg_bytes = cost.rglru_scan_backward(B, S, W, 2)
    rglru_bwd = {"shape": {"B": B, "S": S, "W": W, "a_dtype": "bfloat16"},
                 "implementation": "the ring kernel on the reversed "
                                   "recurrence (RGLRUScanFn.backward)",
                 "kernel_route": "ring", "ms": rg_bwd_ms,
                 "plain_ms": rg_plain_ms, "bytes": rg_bytes,
                 "flops": rg_flops,
                 "bound_ms": max(rg_bytes / HW["hbm_bw"],
                                 rg_flops / HW["peak_flops_fp32"]) * 1e3,
                 "bound_by": "bytes", "library_ms": None,
                 "checked": rg_checked}
    return {"ssd_backward": ssd_bwd, "rglru_backward": rglru_bwd}


def _family_model(arch, n_layers=None, dtype=None, **overrides):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.api import get_model
    cfg = get_arch(arch).full
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                              dtype=dtype or cfg.dtype, **overrides)
    return get_model(cfg)


def _family_batches(cfg, seq, batch, seed, dtype):
    """`SyntheticLM` tokens and labels; for the encoder-decoder also the
    frames: seeded normal (B, enc_seq, d_model) in `dtype`, as the
    reference's tests make them."""
    from repro_torch.data.pipeline import SyntheticLM
    gen = torch.Generator().manual_seed(seed)
    for b in SyntheticLM(cfg.vocab_size, seq, batch, seed=seed):
        if cfg.family == "encdec":
            b["frames"] = torch.randn(batch, cfg.enc_seq, cfg.d_model,
                                      generator=gen).to(dtype)
        yield b


def _expected_train_launches(cfg, n_micro, remat):
    """{kernel: {route: launches}} of one train step of `n_micro`
    microbatches: per microbatch each SSD call once, each RG-LRU scan
    twice (the forward and the backward's reverse scan), each attention
    once on the flash kernel with lse and, in bf16 at Dh 64 / 128, once
    on the backward kernel (which has no routes); under a remat policy
    each forward once more (the backward recomputes the layer)."""
    bf16 = cfg.dtype == "bfloat16"
    again = 0 if remat == "none" else 1
    if cfg.family == "ssm":
        return {"ssd_scan": {"mma_sync" if bf16 else "cuda_core":
                             n_micro * cfg.n_layers * (1 + again)}}
    flash = ("wgmma" if bf16 and cfg.head_dim >= 64 else "cuda_core") + "+lse"
    n_attn = {"hybrid": cfg.n_layers // 3,
              "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}.get(
                  cfg.family, cfg.n_layers)
    out = {"flash_attention": {flash: n_micro * n_attn * (1 + again)}}
    if bf16 and cfg.head_dim in (64, 128):
        out["flash_attention_bwd"] = {"wgmma": n_micro * n_attn}
    if cfg.family == "hybrid":
        out["rglru_scan"] = {"ring": n_micro * (cfg.n_layers - n_attn)
                             * (2 + again)}
    return out


def _check_launches(what, cfg, n_micro, remat):
    """Every kernel launched exactly its expected count on its route."""
    want = _expected_train_launches(cfg, n_micro, remat)
    launches, routes = _read_counts(), _read_routes()
    for name, n in launches.items():
        exp = sum(want.get(name, {}).values())
        got_routes = {r: c for r, c in routes.get(name, {}).items() if c}
        if n != exp or (exp and name in routes
                        and got_routes != want[name]):
            raise AssertionError(f"{what}: {name} launched {n} times on "
                                 f"{got_routes}, expected {want.get(name)}")
    return launches, routes


# arch, depth, overrides, seq, global batch, microbatch: the card-vs-CPU
# train step at the published widths (float32); RecurrentGemma's window
# cut to 128 so that it bites at sequence 256
FAMILY_CROSS = [(TRAIN_ARCH, 2, {}, 512, 2, 2),
                ("mamba2-2.7b", 2, {}, 512, 2, 1),
                ("recurrentgemma-9b", 3, {"local_window": 128}, 256, 2, 1),
                ("whisper-base", 2, {"n_enc_layers": 2}, 64, 2, 1)]


def _hold_train_step(what, got, gm, want, wm, p0, lr):
    """A train step's state `got` (a tree, or its (path, leaf) pairs)
    and metrics `gm` against `want`, `wm` (the same step from the same
    params `p0`, {path: tensor}): the loss and grad_norm within 1e-3
    relative, m and v within 1e-3 of each leaf's max, the params within
    1e-3 (allclose), and the updates themselves (params after minus
    before) within 1e-3 relative plus 1e-2 of the learning rate `lr`,
    save for at most UPDATE_OFF_SHARE of the entries: a gradient within
    rounding of 0 can flip Adam's first step, of size lr. A leaf held on
    the card on both sides is compared there, any other on the CPU.
    Prints the leaf with the worst error of m, of v and of the
    gradients; returns the errors; raises past a bar."""
    from repro_torch.models.params import flatten
    errs = {k: abs(float(gm[k]) - float(wm[k])) / abs(float(wm[k]))
            for k in ("loss", "grad_norm")}
    w = dict(flatten(want))
    worst, flips, off, n = {"opt": 0.0, "params": 0.0}, 0, 0, 0
    # the worst leaf of m and of v: (err / max, path); m = (1 - b1) x the
    # clipped gradient on a first step, so m's leaf is the gradients'
    leaf = {"m": (0.0, None), "v": (0.0, None)}
    for path, t in (flatten(got) if isinstance(got, dict) else got):
        on = t.device if t.is_cuda and w[path].is_cuda else "cpu"
        a, b = t.to(on), w[path].to(on)
        if path.startswith("opt/"):
            err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            worst["opt"] = max(worst["opt"], err)
            kind = path.split("/")[1]
            leaf[kind] = max(leaf[kind], (err, path[len("opt/m/"):]))
        elif path.startswith("params/"):
            worst["params"] = max(worst["params"], float(
                ((a - b).abs() / (1e-3 + 1e-3 * b.abs())).max()))
            before = p0[path[len("params/"):]].to(on)
            da, db = a - before, b - before
            flips += int((da.sign() != db.sign()).sum())
            off += int(((da - db).abs() > 1e-3 * db.abs() + 1e-2 * lr).sum())
            n += b.numel()
    worst_leaf = {"grads": {"leaf": leaf["m"][1], "err_over_max": leaf["m"][0],
                            "from": "m = (1 - b1) x clipped grads, step 1"},
                  **{k: {"leaf": leaf[k][1], "err_over_max": leaf[k][0]}
                     for k in ("m", "v")}}
    print(f"[{what}] worst leaf: {json.dumps(worst_leaf)}", flush=True)
    if max(errs.values()) > 1e-3 or worst["opt"] > 1e-3 or (
            worst["params"] > 1.0) or off > UPDATE_OFF_SHARE * n:
        raise AssertionError(f"{what}: {errs}, m/v err / max {worst['opt']}, "
                             f"params margin {worst['params']}, updates off "
                             f"the bar {off} of {n}")
    return {"rel_err": errs, "mv_err_over_max": worst["opt"],
            "worst_leaf": worst_leaf, "params_margin": worst["params"],
            "update_sign_flips": flips, "updates_off_bar": off,
            "params_total": n}


def train_cross_check(dev, arch, n_layers, overrides, seq, batch, micro):
    """One AdamW train step at the published widths and reduced depth,
    float32, TF32 off, from the same state on the card and on the CPU:
    the loss and grad_norm within 1e-3 relative, m and v within 1e-3 of
    each leaf's max, the params within 1e-3 (allclose), and the updates
    themselves (params after minus before) within 1e-3 relative plus
    1e-2 of the learning rate, save for at most UPDATE_OFF_SHARE of the
    entries: a gradient within rounding of 0 can flip Adam's first step,
    of size lr. Reports how many entries' step changed sign. Every
    kernel launched its expected count on its float32 route."""
    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import to_device
    from repro_torch.models.params import flatten, tree_map
    from repro_torch.train import loop as TL
    model = _family_model(arch, n_layers, "float32", **overrides)
    cfg = model.cfg
    tcfg = TrainConfig(seq_len=seq, global_batch=batch, microbatch=micro,
                       optimizer=OptimizerConfig(warmup_steps=0))
    card_state = TL.init_state(model, tcfg.optimizer, SEED, dev)
    state = tree_map(lambda t: t.cpu(), card_state)
    p0 = {p: t.clone() for p, t in flatten(state["params"])}
    data = next(_family_batches(cfg, seq, batch, SEED, torch.float32))
    step = TL.make_train_step(model, tcfg)
    _zero_counts()
    got, gm = step(card_state, to_device(data, dev))
    torch.cuda.synchronize()
    launches, routes = _check_launches(f"{arch} cross-check", cfg,
                                       batch // micro, "none")
    del card_state
    t0 = time.perf_counter()
    want, wm = step(state, to_device(data, "cpu"))
    cpu_s = time.perf_counter() - t0
    held = _hold_train_step(f"{arch} train card vs CPU", got, gm, want, wm,
                            p0, tcfg.optimizer.lr)
    return {"arch": arch, "n_layers": n_layers, **overrides,
            "dtype": "float32", "seq_len": seq, "global_batch": batch,
            "microbatch": micro, "loss": float(wm["loss"]), **held,
            "cpu_step_s": cpu_s, "launches": launches,
            "route_launches": routes}


# arch, depth (None: the published one), seq, global batch, microbatch,
# remat, timed steps; the cuts are listed in each record. RecurrentGemma
# without remat peaked at 81.4 GB (its f32 gate activations at 2 x 4,096
# beside 45 GB of state) and ran out of memory; "dots" keeps the matmuls'
# outputs and recomputes the rest
FAMILY_FULL = [(TRAIN_ARCH, None, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO,
                "none", 3),
               ("mamba2-2.7b", None, 4096, 8, 2, "full", 2),
               ("recurrentgemma-9b", 8, 4096, 8, 2, "dots", 2),
               ("whisper-base", None, 448, 64, 16, "none", 2)]


def train_full_width(dev, arch, n_layers, seq, batch, micro, remat, steps):
    """Training at the published widths: seeded weights, `SyntheticLM`
    tokens (and seeded bf16 frames for Whisper), bf16 activations, f32
    masters, AdamW, each step spending its state. A warm-up step on one
    microbatch under torch.profiler (where a microbatch's time goes),
    then `steps` timed steps (each ended by reading its loss, a device
    sync) with every kernel's count zeroed before and read after: each
    kernel launched exactly its expected count on its bf16 route.
    Reports step_time_s, train_tok_s, mfu, peak memory (< 80 GB), the
    losses (finite) and the cuts."""
    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch.dryrun_lib import HW, train_model_flops
    from repro_torch.train import loop as TL
    model = _family_model(arch, n_layers)
    cfg = model.cfg
    opt = OptimizerConfig(warmup_steps=1, total_steps=100)
    tcfg = TrainConfig(seq_len=seq, global_batch=batch, microbatch=micro,
                       remat=remat, optimizer=opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state = TL.init_state(model, opt, SEED, dev)
    step = TL.make_train_step(model, tcfg)
    data = _family_batches(cfg, seq, batch, SEED, torch.bfloat16)
    micro_step = TL.make_train_step(model, TrainConfig(
        seq_len=seq, global_batch=micro, remat=remat, optimizer=opt))
    mb = {k: v[:micro] for k, v in to_device(next(data), dev).items()}
    out = {}
    wall, dev_s, top = _device_profile(lambda: out.update(zip(
        ("state", "m"), micro_step(state, mb))))
    state = out["state"]
    losses = [float(out["m"]["loss"])]
    del out, mb
    _zero_counts()
    times = []
    for _ in range(steps):
        b = to_device(next(data), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    launches, routes = _check_launches(f"{arch} full width", cfg,
                                       steps * (batch // micro), remat)
    peak = torch.cuda.max_memory_allocated(dev)
    del state, step, micro_step
    if not all(np.isfinite(losses)) or peak >= DEVICE_BYTES:
        raise AssertionError(f"{arch} train: losses {losses}, peak {peak} B")
    step_s = float(np.median(times))
    tokens = batch * seq
    flops = train_model_flops(model, batch, seq)
    published = _family_model(arch).cfg
    cuts = {}
    if cfg.n_layers != published.n_layers:
        cuts["depth"] = (f"{cfg.n_layers} of {published.n_layers} layers: "
                         f"the f32 masters, gradients and AdamW moments of "
                         f"all {published.n_layers} do not fit one 80 GB "
                         f"card")
    cuts["global_batch"] = (f"{batch} sequences of {seq} tokens a step "
                            f"(microbatches of {micro})")
    return {"arch": arch, "params": model.param_count(),
            "n_layers": cfg.n_layers, "seq_len": seq, "global_batch": batch,
            "microbatch": micro, "remat": remat, "dtype": cfg.dtype,
            "masters": "float32", "optimizer": "adamw", "cuts": cuts,
            "frames_per_clip": cfg.enc_seq if cfg.family == "encdec" else None,
            "step_times_s": times, "step_time_s": step_s,
            "tokens_per_step": tokens, "train_tok_s": tokens / step_s,
            "model_flops_per_step": flops,
            "mfu": flops / (step_s * HW["peak_flops_bf16"]),
            "mfu_peak": "989e12 (H100 SXM dense bf16)", "losses": losses,
            "max_memory_allocated": peak, "launches": launches,
            "route_launches": routes, "profile_microbatch": {
                "tokens": micro * seq, "wall_s": wall, "device_s": dev_s,
                "top": top}}


# ---------------------------------------------------------------------------
# Training and serving sharded over a mesh of the cards
# ---------------------------------------------------------------------------

MESH_SEQ, MESH_BATCH, MESH_STEPS = 1024, 8, 2
MESH_TIMEOUT_S = 600
# arch, depth (None: the published one): SmolLM-135M whole; OLMoE-1B-7B at
# its published widths and 2 of its 16 layers, so that its unsharded step
# (f32 masters, moments and 8 x 1,024 tokens of activations) fits card 0
MESH_TRAIN = [(TRAIN_ARCH, None), ("olmoe-1b-7b", 2)]


def _mesh_rank(rank, world, store, out, work):
    """One process of a mesh phase (spawned): card `rank`, NCCL, TF32
    off; rank 0 writes `work(rank, world)`'s record to `out`. A rank
    that raises exits at once, without leaving the process group (the
    others may be waiting in a collective), so the phase fails fast."""
    import datetime
    import os
    import traceback

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300),
                            device_id=torch.device("cuda", rank))
    try:
        record = work(rank, world)
        if rank == 0:
            Path(out).write_text(json.dumps(record))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def _spawn_mesh(name, work):
    """`work` on W = the card count spawned processes, one card each, under
    one time limit; every process killed if one fails or the limit
    passes. Returns rank 0's record."""
    import tempfile

    import torch.multiprocessing as mp
    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix=f"{name}_") as d:
        out = Path(d) / "record.json"
        ctx = mp.start_processes(_mesh_rank, args=(
            world, str(Path(d) / "store"), str(out), work), nprocs=world,
            join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{name} outlived {MESH_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(30)
        return json.loads(out.read_text())


def _gathered_cpu(state, shardings, keep):
    """{path: CPU tensor} of a state gathered from its shards (a
    collective over its mesh); {} where not `keep`."""
    from repro_torch.models.params import flatten, gather_tree
    full = gather_tree(state, shardings)
    return ({p: t.to("cpu", copy=True) for p, t in flatten(full)} if keep
            else {})


def _mesh_shapes(world):
    """The training meshes: (W, 1) and, for an even W, (W/2, 2)."""
    return [(world, 1)] + ([(world // 2, 2)] if world % 2 == 0 else [])


def _unsharded_steps(model, tcfg, batches, dev):
    """MESH_STEPS train steps unsharded on `dev` from the seeded state:
    (params before, state after, metrics) of each, on the CPU."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.models.params import flatten
    from repro_torch.train import loop as TL
    state = TL.init_state(model, tcfg.optimizer, SEED, dev)
    step = TL.make_train_step(model, tcfg)
    before = {p: t.to("cpu", copy=True) for p, t in flatten(state["params"])}
    want = []
    for b in batches:
        state, m = step(state, to_device(b, dev))
        after = {p: t.to("cpu", copy=True) for p, t in flatten(state)}
        want.append((before, after, {k: float(v) for k, v in m.items()}))
        before = {p[len("params/"):]: t for p, t in after.items()
                  if p.startswith("params/")}
    del state, step
    _free_device_memory()
    return want


def _state_from_rank0(flat, model, opt, mesh, rank):
    """The train state {path: CPU tensor} that rank 0 holds (`flat`; None
    elsewhere), placed onto `mesh`: broadcast from card 0 leaf by leaf,
    each rank keeping its shard."""
    import torch.distributed as dist

    from repro_torch.models.params import flatten, unflatten
    from repro_torch.train import loop as TL
    abstract = TL.abstract_state(model, opt)
    sh = dict(flatten(TL.state_shardings(model, opt, mesh)))
    out = {}
    for path, meta in flatten(abstract):
        t = (flat[path].to(mesh.device) if rank == 0 else torch.empty(
            meta.shape, dtype=meta.dtype, device=mesh.device))
        dist.broadcast(t, src=0)
        out[path] = sh[path].shard(t)
        del t
    return unflatten(abstract, out)


def _abstract_records(model, tcfg, mesh, batch, records, rank):
    """With W >= 2, on rank 0: the same first step as one device of an
    abstract mesh of `mesh`'s axes at rank 0's coordinates
    (`Mesh.abstract`, no process group), its collective records held
    against the real step's `records` item for item; their count (None
    elsewhere)."""
    if mesh.n_devices < 2 or rank != 0:
        return None
    from repro_torch.launch.collectives import COUNTER
    from repro_torch.models.sharding import Mesh
    from repro_torch.train import loop as TL
    amesh = Mesh.abstract(mesh.sizes, mesh.coords, mesh.device)
    state = TL.init_state(model, tcfg.optimizer, SEED, mesh=amesh)
    step = TL.make_train_step(model, tcfg, amesh)
    COUNTER.reset()
    with COUNTER.on():
        step(state, batch)
    got = list(COUNTER.records)
    COUNTER.reset()
    del state, step
    _free_device_memory()
    if got != records:
        n = min(len(got), len(records))
        diff = next((i for i in range(n) if got[i] != records[i]), n)
        raise AssertionError(f"abstract mesh {mesh.sizes}: the first step's "
                             f"collective records differ from the real "
                             f"step's at record {diff} ({len(got)} vs "
                             f"{len(records)} records)")
    return len(got)


def _mesh_train_model(rank, world, arch, n_layers):
    """`arch` (f32) at sequence 1,024, global batch 8: each mesh takes
    MESH_STEPS steps from the seed, held after every step against the
    same steps unsharded on card 0 (`_hold_train_step`) whose
    microbatches are one data shard's rows each for an MoE (its capacity
    is per data shard; a dense model's unsharded step takes the batch
    whole); the first step's collectives and every flash launch
    counted. An MoE's later steps each start from the unsharded state
    before them: its discrete routing turns the first step's rounding
    (Adam's sign flips on gradients within rounding of 0) into other
    expert assignments and capacity drops at the next step, so only a
    step from one state measures the sharded step itself."""
    import torch.distributed as dist

    from repro_torch.config import MeshConfig, OptimizerConfig, TrainConfig
    from repro_torch.launch.collectives import COUNTER
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.launch.roofline import collective_seconds
    from repro_torch.train import loop as TL
    dev = torch.device("cuda", rank)
    model = _family_model(arch, n_layers, "float32")
    moe = model.cfg.family == "moe"
    opt = OptimizerConfig(warmup_steps=0)
    tcfg = TrainConfig(seq_len=MESH_SEQ, global_batch=MESH_BATCH,
                       optimizer=opt)
    data = _family_batches(model.cfg, MESH_SEQ, MESH_BATCH, SEED,
                           torch.float32)
    batches = [next(data) for _ in range(MESH_STEPS)]
    wants = {}           # unsharded microbatch -> its steps, on rank 0
    meshes = []
    for data_n, model_n in _mesh_shapes(world):
        micro = MESH_BATCH // data_n if moe else MESH_BATCH
        if rank == 0 and micro not in wants:
            wants[micro] = _unsharded_steps(model, dataclasses.replace(
                tcfg, microbatch=micro), batches, dev)
        dist.barrier()
        want = wants.get(micro)
        mesh = make_mesh(MeshConfig(data=data_n, model=model_n), "cuda")
        sh = TL.state_shardings(model, opt, mesh)
        state = TL.init_state(model, opt, SEED, mesh=mesh)
        step = TL.make_train_step(model, tcfg, mesh)
        times, held, losses = [], [], []
        torch.cuda.synchronize()
        _zero_counts()
        for i, b in enumerate(batches):
            if i and moe:
                del state
                state = _state_from_rank0(want[i - 1][1] if rank == 0
                                          else None, model, opt, mesh, rank)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                COUNTER.reset()
                with COUNTER.on():
                    state, m = step(state, b)
                records0 = list(COUNTER.records)
            else:
                state, m = step(state, b)
            metrics = {k: float(v) for k, v in m.items()}      # syncs
            times.append(time.perf_counter() - t0)
            losses.append(metrics["loss"])
            if i == 0:
                launches = {r: c for r, c in _read_routes()[
                    "flash_attention"].items() if c}
            got = _gathered_cpu(state, sh, rank == 0)
            if rank == 0:
                held.append(_hold_train_step(
                    f"mesh_train {arch} {data_n}x{model_n} step {i + 1} vs "
                    f"unsharded (microbatches of {micro})", got, metrics,
                    want[i][1], want[i][2], want[i][0], opt.lr))
            del got
        flash = {r: c for r, c in _read_routes()["flash_attention"].items()
                 if c}
        per_step = model.cfg.n_layers * len(batches)
        if flash != {"cuda_core+lse": per_step} or launches != {
                "cuda_core+lse": model.cfg.n_layers}:
            raise AssertionError(f"mesh {data_n}x{model_n} rank {rank}: "
                                 f"flash launches {flash}, expected "
                                 f"{per_step} on cuda_core+lse")
        summary = COUNTER.summary()
        meshes.append({
            **describe(mesh), "shape": [data_n, model_n],
            "unsharded_microbatch": micro,
            "each_step_from_the_unsharded_state": moe,
            "step_times_s": times, "step_time_s": times[-1],
            "losses": losses, "held": held,
            "flash_launches_per_rank": per_step,
            "wire_bytes_per_device_by_kind": {
                k: v["wire_bytes"] for k, v in summary["per_kind"].items()},
            "collective_counts_by_kind": {
                k: v["count"] for k, v in summary["per_kind"].items()},
            "total_wire_bytes_per_device": summary["total_wire_bytes"],
            "collective_s": collective_seconds(summary["total_wire_bytes"],
                                               mesh.n_devices)})
        del state, step
        _free_device_memory()
        meshes[-1]["abstract_records_equal"] = _abstract_records(
            model, tcfg, mesh, batches[0], records0, rank)
    return {"arch": arch, "n_layers": model.cfg.n_layers,
            "params": model.param_count(), "dtype": "float32",
            "seq_len": MESH_SEQ, "global_batch": MESH_BATCH,
            "steps": MESH_STEPS, "meshes": meshes,
            "flash_launches": world * sum(m["flash_launches_per_rank"]
                                          for m in meshes),
            "unsharded_losses": {str(k): [w[2]["loss"] for w in v]
                                 for k, v in wants.items()}}


# arch, depth (None: the published one), seq, global batch: the ssm,
# hybrid and encdec families at their published widths, f32, their
# states kept on the cards for the comparison. Mamba-2 at 2 of 64 layers;
# RecurrentGemma at one superlayer (3 of 38 layers, 1,705,078,784
# parameters: f32 params, m and v of 27.3 GB, which card 0 holds twice,
# the sharded state and the unsharded step's) on 2 x 1,024 tokens;
# Whisper-base whole on 8 clips of 1,500 frames with 448 tokens
MESH_TRAIN_FAMILIES = [("mamba2-2.7b", 2, 1024, 8),
                       ("recurrentgemma-9b", 3, 1024, 2),
                       ("whisper-base", None, 448, 8)]


def _gathered_leaves(state, shardings, rank):
    """(path, whole leaf on the card) of a sharded state, one leaf
    gathered at a time (a collective over its mesh: every rank runs
    it), yielded on rank 0 only."""
    from repro_torch.models.params import flatten
    sh = dict(flatten(shardings))
    for path, t in flatten(state):
        full = sh[path].gather(t)
        if rank == 0:
            yield path, full
        del full


def _mesh_train_family(rank, world, arch, n_layers, seq, batch):
    """`arch` (f32, one microbatch a step): on each mesh MESH_STEPS steps
    from the seed, after each one the unsharded step of the same state on
    card 0 and the sharded state held against it leaf by leaf on the
    card (`_hold_train_step`, the leaves gathered one at a time, no host
    copy of either state). Each step's kernel launches are counted on
    every rank and held to one unsharded step's (`_check_launches`: each
    kernel on local shards once a layer, the RG-LRU twice), the first
    step's collectives counted; the peak memory of each card."""
    import torch.distributed as dist

    from repro_torch.config import MeshConfig, OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch.collectives import COUNTER
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.launch.roofline import collective_seconds
    from repro_torch.models.params import flatten
    from repro_torch.train import loop as TL
    dev = torch.device("cuda", rank)
    model = _family_model(arch, n_layers, "float32")
    cfg = model.cfg
    opt = OptimizerConfig(warmup_steps=0)
    tcfg = TrainConfig(seq_len=seq, global_batch=batch, optimizer=opt)
    data = _family_batches(cfg, seq, batch, SEED, torch.float32)
    batches = [next(data) for _ in range(MESH_STEPS)]
    plain = TL.make_train_step(model, tcfg)
    meshes, total = [], dict.fromkeys(_kernel_counters(), 0)
    for data_n, model_n in _mesh_shapes(world):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        want = p0 = None
        if rank == 0:
            want = TL.init_state(model, opt, SEED, dev)
            p0 = {p: t.clone() for p, t in flatten(want["params"])}
        mesh = make_mesh(MeshConfig(data=data_n, model=model_n), "cuda")
        sh = TL.state_shardings(model, opt, mesh)
        state = TL.init_state(model, opt, SEED, mesh=mesh)
        step = TL.make_train_step(model, tcfg, mesh)
        times, held, losses = [], [], []
        for i, b in enumerate(batches):
            if rank == 0:
                want, wm = plain(want, to_device(b, dev))
                wm = {k: float(v) for k, v in wm.items()}
            torch.cuda.synchronize()
            dist.barrier()
            _zero_counts()
            t0 = time.perf_counter()
            if i == 0:
                COUNTER.reset()
                with COUNTER.on():
                    state, m = step(state, b)
                records0 = list(COUNTER.records)
            else:
                state, m = step(state, b)
            metrics = {k: float(v) for k, v in m.items()}      # syncs
            times.append(time.perf_counter() - t0)
            losses.append(metrics["loss"])
            launches, routes = _check_launches(
                f"mesh_train {arch} {data_n}x{model_n} rank {rank}", cfg, 1,
                "none")
            for k, c in launches.items():
                total[k] += world * c
            leaves = _gathered_leaves(state, sh, rank)
            if rank == 0:
                held.append(_hold_train_step(
                    f"mesh_train {arch} {data_n}x{model_n} step {i + 1} vs "
                    f"unsharded", leaves, metrics, want, wm, p0, opt.lr))
                for p, t in flatten(want["params"]):
                    p0[p].copy_(t)
            else:
                for _ in leaves:
                    pass
        summary = COUNTER.summary()
        peaks = _all_ranks(torch.cuda.max_memory_allocated(dev))
        meshes.append({
            **describe(mesh), "shape": [data_n, model_n],
            "step_times_s": times, "step_time_s": times[-1],
            "losses": losses, "held": held,
            "launches_per_rank_per_step": {
                k: {r: c for r, c in routes.get(k, {}).items() if c}
                or launches[k] for k in launches if launches[k]},
            "peak_gb_per_card": [p / 1e9 for p in peaks],
            "wire_bytes_per_device_by_kind": {
                k: v["wire_bytes"] for k, v in summary["per_kind"].items()},
            "collective_counts_by_kind": {
                k: v["count"] for k, v in summary["per_kind"].items()},
            "total_wire_bytes_per_device": summary["total_wire_bytes"],
            "collective_s": collective_seconds(summary["total_wire_bytes"],
                                               mesh.n_devices)})
        del state, step, want, p0
        _free_device_memory()
        meshes[-1]["abstract_records_equal"] = _abstract_records(
            model, tcfg, mesh, batches[0], records0, rank)
    return {"arch": arch, "n_layers": cfg.n_layers,
            "params": model.param_count(), "dtype": "float32",
            "seq_len": seq, "global_batch": batch, "steps": MESH_STEPS,
            "meshes": meshes, "launches": total}


def _mesh_train_work(rank, world):
    """Each of MESH_TRAIN on the meshes (`_mesh_train_model`), then each
    of MESH_TRAIN_FAMILIES (`_mesh_train_family`); then an ElasticJob of
    SmolLM-135M on all cards migrates to the first ceil(W/2) and back,
    its state gathered before and after each migration and held
    bit-equal."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.core.elastic import ElasticJob
    models = [_mesh_train_model(rank, world, arch, n)
              for arch, n in MESH_TRAIN]
    families = [_mesh_train_family(rank, world, *f)
                for f in MESH_TRAIN_FAMILIES]
    launches = dict.fromkeys(_kernel_counters(), 0)
    launches["flash_attention"] = sum(m["flash_launches"] for m in models)
    for f in families:
        for k, c in f["launches"].items():
            launches[k] += c
    model = _family_model(TRAIN_ARCH, None, "float32")
    tcfg = TrainConfig(seq_len=MESH_SEQ, global_batch=MESH_BATCH,
                       optimizer=OptimizerConfig(warmup_steps=0))
    data = _family_batches(model.cfg, MESH_SEQ, MESH_BATCH, SEED,
                           torch.float32)
    batches = [next(data) for _ in range(MESH_STEPS)]
    cards = [torch.device("cuda", r) for r in range(world)]
    half = cards[:(world + 1) // 2]
    migrations, bit_equal = [], []
    with tempfile.TemporaryDirectory(prefix="mesh_train_") as ckpt:
        job = ElasticJob(model, tcfg, ckpt)
        job.start(cards)
        job.train_step(batches[0])
        for target in (half, cards):
            before = (_gathered_cpu(job.state, job.state_shardings(),
                                    rank == 0) if job.member else {})
            migrations.append(job.migrate(target))
            after = (_gathered_cpu(job.state, job.state_shardings(),
                                   rank == 0) if job.member else {})
            if rank == 0:
                same = before.keys() == after.keys() and all(
                    torch.equal(before[p], after[p]) for p in before)
                if not same:
                    raise AssertionError(f"mesh_train: the state after the "
                                         f"migration to {len(target)} cards "
                                         f"differs from the one before")
                bit_equal.append(len(target))
        job.train_step(batches[1])
        dist.barrier()
    return {"world": world, "models": models, "families": families,
            "launches": launches, "migrations": migrations,
            "bit_equal_after_migration_to": bit_equal}


def mesh_train_phase(dev):
    """Training sharded over the cards: W = the card count ranks, one card
    each, over NCCL (`_mesh_train_work`), spawned with a time limit.
    Prints W, each model and mesh, its step times, the first step's wire
    bytes per device by kind with the roofline's collective seconds, the
    migrations and the flash launches."""
    record = _spawn_mesh("mesh_train", _mesh_train_work)
    world = record["world"]
    for r in record["models"]:
        print(f"[mesh_train] W = {world} card(s), {r['arch']} "
              f"({r['n_layers']} layers) f32 at {MESH_BATCH} x {MESH_SEQ} "
              f"tokens a step", flush=True)
        for m in r["meshes"]:
            errs = [{k: h[k] for k in ("rel_err", "mv_err_over_max",
                                       "params_margin", "updates_off_bar")}
                    for h in m["held"]]
            print(f"[mesh_train] {r['arch']} mesh {m['axes']}: step times "
                  f"{m['step_times_s']} s, wire bytes per device per step "
                  f"by kind {m['wire_bytes_per_device_by_kind']} (total "
                  f"{m['total_wire_bytes_per_device']}, collective_s "
                  f"{m['collective_s']} at NVLink 4's 450 GB/s a "
                  f"direction, a data-sheet figure), vs unsharded in "
                  f"microbatches of {m['unsharded_microbatch']} (bars "
                  f"1e-3): {errs}", flush=True)
    for r in record["families"]:
        for m in r["meshes"]:
            errs = [{k: h[k] for k in ("rel_err", "mv_err_over_max",
                                       "params_margin", "updates_off_bar")}
                    for h in m["held"]]
            print(f"[mesh_train] {r['arch']} ({r['n_layers']} layers, "
                  f"{r['params']} parameters) f32 at {r['global_batch']} x "
                  f"{r['seq_len']} tokens a step, mesh {m['axes']}: step "
                  f"times {m['step_times_s']} s, peak GB per card "
                  f"{m['peak_gb_per_card']}, launches per rank per step "
                  f"{m['launches_per_rank_per_step']}, wire bytes per "
                  f"device per step by kind "
                  f"{m['wire_bytes_per_device_by_kind']}, vs unsharded on "
                  f"card 0 (bars 1e-3): {errs}", flush=True)
    if world == 1:
        print("[mesh_train] one card: the (1, 1) mesh runs the mesh path "
              "and issues no collective", flush=True)
    print(f"[mesh_train] migrations {record['migrations']}, bit-equal "
          f"after each; kernel launches {record['launches']}", flush=True)
    return record


# the served models on a mesh: f32 at reduced depth against the
# unsharded model (arch, overrides, prompt length; RecurrentGemma at one
# superlayer and a trailing block with its window cut to 128, so that it
# bites in the prefill and the ring wraps; Whisper whole on 4 clips of
# 1,500 seeded frames), then bf16 at full width at phase 7's shapes
# (`SERVE_FULL`: 4 prompts of 2,048 tokens; Whisper 8 clips of zero
# frames with 4-token prompts), 32 new tokens
MESH_SERVE_CHECK = [("phi4-mini-3.8b", {"n_layers": 2}, 128),
                    ("olmoe-1b-7b", {"n_layers": 2}, 128),
                    ("mamba2-2.7b", {"n_layers": 2}, 256),
                    ("recurrentgemma-9b", {"n_layers": 4,
                                           "local_window": 128}, 256),
                    ("whisper-base", {}, 4)]
MESH_SERVE = ["phi4-mini-3.8b", "olmoe-1b-7b", "mamba2-2.7b",
              "recurrentgemma-9b", "whisper-base"]
MESH_CHECK_STEPS = 8


def _serve_meshes(world):
    """The serving meshes: (W, 1) and, for W >= 2, (1, W): expert-parallel
    over every card."""
    return [(world, 1)] + ([(1, world)] if world >= 2 else [])


def _mesh_serve_check(rank, world, arch, overrides, S):
    """Published widths at the depth `overrides` give, f32, TF32 off,
    batch 4 of `S`-token prompts (an encoder-decoder's with seeded
    frames): on each mesh the prefill and MESH_CHECK_STEPS decode steps
    fed card 0's greedy tokens, every step's gathered logits within 1e-3
    (abs and rel) of the unsharded model's on card 0, run on each data
    shard's prompts alone (an MoE's capacity is per data shard), and
    their greedy tokens equal."""
    import torch.distributed as dist

    from repro_torch.config import MeshConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import shard_tree
    from repro_torch.models.sharding import NamedSharding, logical_to_pspec
    dev = torch.device("cuda", rank)
    model = _serving_model(arch, dtype="float32", **overrides)
    cfg = model.cfg
    B = 4
    pad = S + MESH_CHECK_STEPS
    inputs = {"tokens": torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S)))}
    if cfg.family == "encdec":
        inputs["frames"] = torch.randn(
            B, cfg.enc_seq, cfg.d_model,
            generator=torch.Generator().manual_seed(SEED))
    full = model.init(SEED, device=dev)
    out = []
    for data_n, model_n in _serve_meshes(world):
        rows = B // data_n
        want = None
        if rank == 0:         # unsharded, one data shard's prompts at a time
            want = []
            for d in range(data_n):
                p = {k: v[d * rows:(d + 1) * rows].to(dev)
                     for k, v in inputs.items()}
                lg, cache = model.prefill(full, p, pad_to=pad)
                steps = [lg.cpu()]
                for _ in range(MESH_CHECK_STEPS):
                    lg, cache = model.decode(full, cache,
                                             torch.argmax(lg, -1))
                    steps.append(lg.cpu())
                want.append(torch.stack(steps))
            want = torch.cat(want, dim=1)           # (steps + 1, B, V)
            del cache
        box = [None if want is None else torch.argmax(want, -1)]
        dist.broadcast_object_list(box, src=0)
        tokens = box[0]                              # card 0's greedy tokens
        mesh = make_mesh(MeshConfig(data=data_n, model=model_n),
                         "cuda").for_batch((B, S))
        params = shard_tree(full, model.shardings(mesh))
        lsh = NamedSharding(mesh, logical_to_pspec(("batch", "tp"),
                                                   (B, cfg.vocab_size), mesh))
        tsh = NamedSharding(mesh, logical_to_pspec(("batch",), (B,), mesh))
        lg, cache = model.prefill(params, shard_batch(inputs, mesh),
                                  pad_to=pad, mesh=mesh)
        got = [lsh.gather(lg).cpu()]
        for i in range(MESH_CHECK_STEPS):
            lg, cache = model.decode(params, cache,
                                     tsh.shard(tokens[i].to(dev)), mesh=mesh)
            got.append(lsh.gather(lg).cpu())
        del params, cache
        if rank == 0:
            got = torch.stack(got)
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=1e-3, rtol=1e-3) or not (
                    torch.equal(torch.argmax(got, -1), tokens)):
                raise AssertionError(f"mesh_serve {arch} {data_n}x{model_n}: "
                                     f"logits differ from the unsharded "
                                     f"engine's by {err}, or its greedy "
                                     f"tokens do")
            out.append({"shape": [data_n, model_n], "max_abs_err": err,
                        "max_abs_logit": float(want.abs().max()),
                        "greedy_equal": True})
    del full
    _free_device_memory()
    return {"arch": arch, **overrides, "n_layers": cfg.n_layers,
            "dtype": "float32", "batch": B, "prompt_len": S,
            "decode_steps": MESH_CHECK_STEPS, "meshes": out}


def _all_ranks(value):
    import torch.distributed as dist
    box = [None] * dist.get_world_size()
    dist.all_gather_object(box, value)
    return box


def _mesh_serve_full(rank, world, arch):
    """bf16 at the published widths on each mesh, at phase 7's shapes
    (`SERVE_FULL`): `ServeEngine(mesh=)` loads seeded weights (each card
    its shards), a warm-up, then `generate` of SERVE_NEW_TOKENS greedy
    tokens with every kernel's count zeroed before and read after (each
    card launches phase 7's kernels once a layer of the prefill, on the
    local shards, on `MAIN_ROUTES`); then one prefill and one decode
    step with the collectives counted, and an MoE's first-layer
    router_dropped."""
    from repro_torch.config import MeshConfig
    from repro_torch.launch.collectives import COUNTER
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import flatten
    from repro_torch.serve.engine import ServeEngine, throughput_tokens_per_s
    dev = torch.device("cuda", rank)
    model = _serving_model(arch)
    cfg = model.cfg
    _, B, S, warmup, expected = {a: rest for a, *rest in SERVE_FULL}[arch]
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, S))
    out, total = [], dict.fromkeys(_kernel_counters(), 0)
    for data_n, model_n in _serve_meshes(world):
        mesh = make_mesh(MeshConfig(data=data_n, model=model_n), "cuda")
        engine = ServeEngine(model, mesh=mesh).load(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)        # serving, not init
        engine.generate(prompts[:, :warmup], 2)         # warm-up
        engine.stats = dict.fromkeys(engine.stats, 0)
        _zero_counts()
        res = engine.generate(prompts, SERVE_NEW_TOKENS)
        torch.cuda.synchronize()
        launches, routes = _read_counts(), _read_routes()
        want = {n: expected.get(n, 0) for n in launches}
        if launches != want or any(routes[n].get(r, 0) != want[n]
                                   for n, r in MAIN_ROUTES.items()):
            raise AssertionError(f"mesh_serve {arch} {data_n}x{model_n} "
                                 f"rank {rank}: launches {launches} on "
                                 f"{routes}, expected {want} on "
                                 f"{MAIN_ROUTES}")
        for n, c in launches.items():
            total[n] += world * c
        toks = res["tokens"]
        if toks.shape != (B, SERVE_NEW_TOKENS) or toks.min() < 0 or (
                toks.max() >= cfg.vocab_size):
            raise AssertionError(f"mesh_serve {arch}: tokens of shape "
                                 f"{toks.shape} in [{toks.min()}, "
                                 f"{toks.max()}]")
        peaks = _all_ranks(torch.cuda.max_memory_allocated(dev))
        params = engine.prepared_params()
        run_mesh = mesh.for_batch((B, S))
        batch = engine.prefill_batch(prompts)
        wire = {}
        COUNTER.reset()
        with COUNTER.on():
            lg, cache = model.prefill(params, batch, pad_to=S + 1,
                                      mesh=run_mesh)
        wire["prefill"] = COUNTER.summary()
        COUNTER.reset()
        tok = engine._rows(torch.argmax(engine._whole(lg, B), -1), B)
        with COUNTER.on():
            model.decode(params, cache, tok, mesh=run_mesh)
        wire["decode_step"] = COUNTER.summary()
        COUNTER.reset()
        del lg, cache
        rec = {"shape": [data_n, model_n],
               **throughput_tokens_per_s(res["stats"]),
               "prefill_s": res["stats"]["prefill_s"],
               "decode_s": res["stats"]["decode_s"],
               "peak_gb_per_card": [p / 1e9 for p in peaks],
               "launches_per_card": {
                   n: {r: c for r, c in routes.get(n, {}).items() if c}
                   or c for n, c in launches.items() if c},
               "wire_bytes_per_device_by_kind": {
                   k: {kind: v["wire_bytes"] for kind, v in
                       w["per_kind"].items()} for k, w in wire.items()},
               "tokens_head": toks[:, :8].tolist()}
        if cfg.family == "encdec":
            rec["enc_frames_per_s"] = (B * cfg.enc_seq
                                       / res["stats"]["prefill_s"])
        if cfg.family == "moe":
            lay, _, lspecs, _, x, _ = T._serve_setup(
                cfg, params, batch["tokens"], S, run_mesh)
            _, aux = T._mesh_layer(cfg, lay, lspecs, x, dict(flatten(
                T.layer(params["layers"], 0))), torch.arange(S, device=dev))
            rec["layer0_router_dropped"] = float(aux["router_dropped"])
        if max(peaks) >= DEVICE_BYTES:
            raise AssertionError(f"mesh_serve {arch}: peak memory {peaks} B")
        out.append(rec)
        del engine, params, batch
        _free_device_memory()
    return {"arch": arch, "params": model.param_count(), "dtype": cfg.dtype,
            "batch": B, "prompt_len": S, "new_tokens": SERVE_NEW_TOKENS,
            "meshes": out, "launches": total}


def _mesh_serve_work(rank, world):
    checks = [_mesh_serve_check(rank, world, *c) for c in MESH_SERVE_CHECK]
    full = [_mesh_serve_full(rank, world, a) for a in MESH_SERVE]
    launches = dict.fromkeys(_kernel_counters(), 0)
    for r in full:
        for n, c in r["launches"].items():
            launches[n] += c
    return {"world": world, "cross_check": checks, "full_width": full,
            "launches": launches}


def mesh_serve_phase(dev):
    """Serving sharded over the cards: W = the card count ranks, one card
    each, over NCCL (`_mesh_serve_work`), spawned with a time limit. Prints
    each model's f32 cross-check, and per mesh its prefill and decode
    tokens per second, peak GB per card, wire bytes per device by kind of
    one prefill and one decode step, flash launches by route and an MoE's
    first-layer router_dropped."""
    record = _spawn_mesh("mesh_serve", _mesh_serve_work)
    world = record["world"]
    for r in record["cross_check"]:
        print(f"[mesh_serve] {r['arch']} f32 {r['n_layers']} layers, prefill + "
              f"{r['decode_steps']} decode steps vs the unsharded engine on "
              f"card 0 (bars 1e-3, greedy tokens equal): "
              f"{json.dumps(r['meshes'])}", flush=True)
    for r in record["full_width"]:
        for m in r["meshes"]:
            print(f"[mesh_serve] {r['arch']} bf16 full width, mesh "
                  f"{m['shape']}: {json.dumps(m)}", flush=True)
    if world == 1:
        print("[mesh_serve] one card: the (1, 1) mesh runs the mesh path "
              "and issues no collective", flush=True)
    return record


# ---------------------------------------------------------------------------
# The dry run and roofline; the reference's user entry points
# ---------------------------------------------------------------------------

# cells of configs.registry.all_cells(): 32 run, the 8 full-attention
# long_500k cells are skipped with the reference's reasons
DRYRUN_RUN, DRYRUN_SKIPPED = 32, 8
# the one runnable cell whose probe depth does not fit one card: DBRX's
# two-layer train probe, ~6.6 B parameters with f32 masters and AdamW
DRYRUN_UNPROBED = {"dbrx-132b__train_4k"}


def dryrun_phase(dev, measured):
    """`python -m repro_torch.launch.dryrun --all` on the card (every
    cell's memory, model FLOPs and marginal-layer probes at the published
    widths), then the roofline of the runnable cells; `measured` maps
    "<arch>__<shape>" to a step time this run measured (SmolLM-135M at
    train_4k, phase 9). Every cell's model FLOPs equal the host
    formula's, every probed FLOP count is positive, the cells left
    unprobed (they do not fit one card) are exactly `DRYRUN_UNPROBED`
    (any error, out of memory included, fails the cell and the phase),
    and the cost counter's calls equal the kernels' launch counters over
    the phase."""
    from repro_torch.kernels.cost import COUNTER
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import dryrun_lib as DL
    save = OUT / "dryrun"
    COUNTER.reset()
    _zero_counts()
    t0 = time.perf_counter()
    rc = dryrun.main(["--all", "--device", "cuda", "--save-dir", str(save)])
    run_s = time.perf_counter() - t0
    launches, calls = _read_counts(), dict(COUNTER.calls)
    cells = roofline.load_cells(str(save))
    ok = [r for r in cells if r["status"] == "ok"]
    problems = []
    if rc or len(ok) != DRYRUN_RUN or len(cells) - len(ok) != DRYRUN_SKIPPED:
        problems.append(f"dryrun rc {rc}, {len(ok)} cells ok of {len(cells)}")
    if calls != launches:
        problems.append(f"cost counter calls {calls} != launches {launches}")
    for r in ok:
        where = f"{r['arch']} x {r['shape']}"
        if r["model_flops_global"] != DL.model_flops(r["arch"], r["shape"]):
            problems.append(f"{where}: model FLOPs {r['model_flops_global']}")
        probed = r.get("cost_probed")
        if probed is not None and not probed["flops"] > 0:
            problems.append(f"{where}: probed FLOPs {probed['flops']}")
    not_probed = {f"{r['arch']}__{r['shape']}": r.get("probe")
                  for r in ok if "cost_probed" not in r}
    if set(not_probed) != DRYRUN_UNPROBED:
        problems.append(f"not probed: {not_probed}, expected only "
                        f"{sorted(DRYRUN_UNPROBED)}")
    if problems:
        raise AssertionError(f"dry run: {problems}")
    rows = [roofline.roofline_row(r, measured.get(f"{r['arch']}__{r['shape']}"))
            for r in cells]
    (save / "roofline.json").write_text(json.dumps(rows, indent=1))
    return {"run_s": run_s, "launches": launches, "cost_calls": calls,
            "cost_flops": dict(COUNTER.flops), "cost_bytes": dict(COUNTER.bytes),
            "not_probed": not_probed,
            "rows": rows, "table": roofline.markdown_table(rows)}


# the dry run on the reference's production meshes (phase 11b): the four
# hill-climb cells, RecurrentGemma's 38 layers, a prefill of Mamba-2 and of
# Whisper on 16x16; chameleon on 2x16x16; the variants that cover every lever
DRYRUN_MESH_SINGLE = [("chameleon-34b", "train_4k"),
                      ("smollm-135m", "train_4k"),
                      ("dbrx-132b", "train_4k"),
                      ("starcoder2-15b", "decode_32k"),
                      ("recurrentgemma-9b", "train_4k"),
                      ("mamba2-2.7b", "prefill_32k"),
                      ("whisper-base", "prefill_32k")]
DRYRUN_MESH_MULTI = [("chameleon-34b", "train_4k")]
HILLCLIMB_VARIANTS = ("A1", "A6", "A9", "B1", "B3", "C1", "C2", "D1", "D2")


def _mesh_cell_problems(res: dict, where: str) -> list:
    """A mesh cell's checks: its per-device argument bytes recomputed on
    the host over a plain {axis: size} mapping (no `Mesh`) under its
    rules, and wire bytes > 0 on a mesh of more than one device."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun_lib as DL
    from repro_torch.models.sharding import rules_ctx
    cfg = dataclasses.replace(get_arch(res["arch"]).full, **{
        k: (v == "True" if v in ("True", "False") else v)
        for k, v in res.get("cfg_kw", {}).items()})
    rules = {k: tuple(v) for k, v in res.get("rules_override", {}).items()}
    with rules_ctx(rules or None):
        host = DL.mesh_memory_stats(cfg, res["shape"], res["mesh"]["axes"],
                                    res["card_bytes"])
    out = []
    if host["argument_bytes"] != res["memory"]["argument_bytes"]:
        out.append(f"{where}: argument bytes {res['memory']['argument_bytes']}"
                   f" != the host formula's {host['argument_bytes']}")
    wire = res.get("collectives", {}).get("total_wire_bytes", 0.0)
    if res["devices"] > 1 and not wire > 0:
        out.append(f"{where}: wire bytes {wire}")
    return out


def dryrun_mesh_phase(dev, card):
    """The dry run on the production meshes (`dryrun --mesh single` and
    `--mesh multi` on `DRYRUN_MESH_*`) and the hill-climb variants
    `HILLCLIMB_VARIANTS` (`python -m repro_torch.launch.hillclimb
    --only ...`), each one device of its abstract mesh on this card;
    the checks of `_mesh_cell_problems` on every cell and variant, DBRX's
    train cell probed, PURE_DP's and SERVE_TP's layouts, and the cost
    counter's calls equal to the kernels' launches over the phase.
    Per-device bytes on a 256- or 512-device mesh are arithmetic, not a
    measurement of those cards."""
    from repro_torch.kernels.cost import COUNTER
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.roofline import axis_seconds, roofline_row
    save, hc_dir = OUT / "dryrun", OUT / "hillclimb"
    COUNTER.reset()
    _zero_counts()
    t0 = time.perf_counter()
    rcs = {}
    for mesh, cells in (("single", DRYRUN_MESH_SINGLE),
                        ("multi", DRYRUN_MESH_MULTI)):
        for arch, shape in cells:
            rcs[f"{mesh} {arch} {shape}"] = dryrun.main([
                "--mesh", mesh, "--arch", arch, "--shape", shape,
                "--device", "cuda", "--save-dir", str(save)])
    rcs["hillclimb"] = hillclimb.main(["--only", ",".join(HILLCLIMB_VARIANTS),
                                       "--out-dir", str(hc_dir)])
    run_s = time.perf_counter() - t0
    launches, calls = _read_counts(), dict(COUNTER.calls)
    problems = [f"{k}: rc {rc}" for k, rc in rcs.items() if rc]
    if calls != launches:
        problems.append(f"cost counter calls {calls} != launches {launches}")
    cells = {}
    for mesh, group in (("single_pod", DRYRUN_MESH_SINGLE),
                        ("multi_pod", DRYRUN_MESH_MULTI)):
        for arch, shape in group:
            path = save / mesh / f"{arch}__{shape}.json"
            if path.exists():
                cells[f"{mesh}/{arch}__{shape}"] = json.loads(path.read_text())
            else:
                problems.append(f"{mesh} {arch} {shape}: no JSON")
    variants = {}
    for path in sorted(hc_dir.glob("*.json")):
        res = json.loads(path.read_text())
        variants[res["variant"].split("_")[0]] = res
    if sorted(variants) != sorted(HILLCLIMB_VARIANTS):
        problems.append(f"variants written: {sorted(variants)}")
    for where, res in list(cells.items()) + list(variants.items()):
        problems += _mesh_cell_problems(res, where)
    dbrx = cells.get("single_pod/dbrx-132b__train_4k", {})
    if "cost_probed" not in dbrx:
        problems.append(f"DBRX train_4k not probed on 16x16: "
                        f"{dbrx.get('probe')}")
    for key in ("B1", "B3"):
        model = variants.get(key, {}).get("collectives", {}).get(
            "per_axis", {}).get("model", {})
        if any(model.get(k) for k in ("all-gather", "reduce-scatter",
                                      "all-to-all", "collective-permute")):
            problems.append(f"{key} (PURE_DP): {model} over model")
    c2 = variants.get("C2", {}).get("collectives", {}).get(
        "per_axis", {}).get("data", {})
    if c2.get("all-gather"):
        problems.append(f"C2 (SERVE_TP) gathers over data: {c2}")
    if problems:
        raise AssertionError(f"dryrun_mesh: {problems}")

    def row(res):
        mem = res["memory"]
        coll = res.get("collectives", {})
        out = {"devices": res["devices"], "mesh": res["mesh"]["axes"],
               "argument_bytes": mem["argument_bytes"],
               "probe_peak_bytes": mem.get("probe_peak_bytes"),
               "wire_bytes": coll.get("total_wire_bytes"),
               "wire_by_kind": {k: v["wire_bytes"] for k, v in
                                coll.get("per_kind", {}).items()},
               "wire_by_axis": {k: v["wire_bytes"] for k, v in
                                coll.get("per_axis", {}).items()},
               "collective_s": axis_seconds(coll.get("per_axis", {})),
               "kernel_calls": {k: v for k, v in res.get(
                   "kernel_calls", {}).items() if v}}
        if "cost_probed" in res:
            r = roofline_row(res)
            out.update({k: r[k] for k in ("compute_s", "memory_s",
                                          "dominant", "useful_ratio")})
            out["flops"] = res["cost_probed"]["flops"]
        return out
    summary = {"card": card, "run_s": run_s, "launches": launches,
               "cost_calls": calls,
               "note": "per-device bytes of 256/512-device meshes: "
                       "arithmetic and one device's probes on this card, "
                       "not a measurement of those cards",
               "cells": {k: row(r) for k, r in cells.items()},
               "variants": {k: {**row(r), "name": r["variant"]}
                            for k, r in variants.items()}}
    for k, r in {**summary["cells"], **summary["variants"]}.items():
        print(f"[dryrun_mesh] {card}: {k} on {r['mesh']}: args "
              f"{r['argument_bytes']/1e9:.4f} GB a device, probe peak "
              f"{(r['probe_peak_bytes'] or 0)/1e9:.2f} GB, wire "
              f"{(r['wire_bytes'] or 0)/1e9:.4f} GB a device by axis "
              f"{r['wire_by_axis']}, collective_s {r['collective_s']:.5f} "
              f"(data-sheet links)", flush=True)
    return summary


# the sweep examples at a reduced size, card against CPU (bit-equal rows:
# the sweep path's card arithmetic is the CPU's through devmath)
EXAMPLES_SMALL = {
    "elasticity_demo": ["--containers", "200", "--days", "2",
                        "--sweep-traces", "16"],
    "traffic_demo": ["--users", "20000", "--sweep-traces", "8"],
    "simulate_regions": ["--torch-sweep", "--containers", "480"],
}


def _same(a, b, where):
    """Exact equality of two nested summaries (dicts, lists, numbers)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{where}: keys {sorted(a)} != {sorted(b)}")
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: {len(a)} != {len(b)} entries")
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        if not np.array_equal(a, b):
            raise AssertionError(f"{where}: arrays differ")
    elif a != b and not (isinstance(a, float) and np.isnan(a)
                         and np.isnan(b)):
        raise AssertionError(f"{where}: {a!r} != {b!r}")


def examples_phase(dev):
    """The five examples (`repro_torch.examples`) on the card at the
    reference's defaults, each held to its own verdict: quickstart's
    loss falls and it generates (4, 12) tokens; carbon_train's average
    C(t) <= its target; elasticity_demo's forecast saves carbon per unit
    of work, within the oracle's bound, with no budget violation;
    traffic_demo's carbon routing emits less per request, violating the
    SLO no more than latency routing; simulate_regions' 10,080-container
    placed sweep gives the CPU's rows exactly (every key of every row).
    Then the sweep examples at a reduced size on the card and on the
    CPU: summaries equal."""
    import contextlib
    import io
    from importlib import import_module
    out, problems = {}, []
    _zero_counts()
    for name, argv in (("quickstart", []), ("carbon_train", []),
                       ("elasticity_demo", []), ("traffic_demo", []),
                       ("simulate_regions", ["--torch-sweep"])):
        mod = import_module(f"repro_torch.examples.{name}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            res = mod.main(argv + ["--device", "cuda"])
        out[name] = {"wall_s": time.perf_counter() - t0,
                     "last_lines": text.getvalue().strip().splitlines()[-3:]}
        if name == "quickstart":
            ok = (res["loss_last"] < res["loss_first"]
                  and res["tokens"].shape == (4, 12))
            out[name].update(loss=[res["loss_first"], res["loss_last"]])
        elif name == "carbon_train":
            ok = res["enforced"] and res["steps"] == 200
            out[name].update({k: res[k] for k in (
                "avg_rate_g_per_h", "target_g_per_h", "migrations")})
        elif name == "elasticity_demo":
            ok = (0 < res["forecast_saving"] <= res["oracle_bound"]
                  and all(s["elastic_cap_violations"] == 0
                          for s in res["ablation"].values())
                  and res["sweep_rows"][0]["elastic_cap_violations"] == 0)
            out[name].update(forecast_saving=res["forecast_saving"],
                             oracle_bound=res["oracle_bound"])
        elif name == "traffic_demo":
            rt = res["routing"]
            ok = (res["carbon_saving"] > 0 and rt["carbon"]["violations"]
                  <= rt["latency"]["violations"])
            out[name].update(carbon_saving=res["carbon_saving"])
        else:
            sw = res["torch_sweep"]
            ok = sw["drift"] == 0.0 and sw["containers"] == 10080
            try:
                _same(sw["rows"], sw["cpu_rows"], f"{name} card vs CPU")
            except AssertionError as e:
                ok = False
                problems.append(str(e))
            out[name].update({k: sw[k] for k in (
                "containers", "epochs", "first_s", "steady_s", "cpu_s",
                "container_epochs_per_s", "drift")})
        if not ok:
            problems.append(f"{name}: {out[name]}")
    out["launches"] = _read_counts()
    for name, argv in EXAMPLES_SMALL.items():
        mod = import_module(f"repro_torch.examples.{name}")
        with contextlib.redirect_stdout(io.StringIO()):
            card = mod.main(argv + ["--device", "cuda"])
            cpu = mod.main(argv + ["--device", "cpu"])
        for res in (card, cpu):   # wall times and the card's CPU rerun
            for k in ("first_s", "steady_s", "container_epochs_per_s",
                      "cpu_s", "drift", "cpu_rows"):
                res.get("torch_sweep", {}).pop(k, None)
        try:
            _same(card, cpu, f"{name} card vs CPU")
        except AssertionError as e:
            problems.append(str(e))
        out[f"{name}_card_vs_cpu"] = {"argv": argv, "equal": True}
    if problems:
        raise AssertionError(f"examples: {problems}")
    return out


def _kernel_counters():
    """{library name: the wrapper whose `launches` counts that kernel's
    launches}."""
    from repro_torch.cluster.placement_kernel import admission_rounds
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"admission_round": admission_rounds,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_backward,
            "ssd_scan": ssd_scan, "rglru_scan": rglru_scan}


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
            ("flash_attention_bwd", "flash_bwd_wgmma", ("HGMMA",)),
            ("flash_attention_bwd", "flash_bwd_wgmma", ("UTMALDG",)),
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


# arch, prompt length and overrides of the card-vs-CPU checks (float32,
# the published widths): phi4-mini and Mamba-2 at 2 layers;
# RecurrentGemma at one superlayer plus one trailing recurrent block, so
# both scan groups run, with its window cut to 128 so that it bites in
# the prefill's flash launch and the ring wraps in decode; OLMoE at 2
# layers (its routing ids held exactly); Whisper-base whole, on 2 clips
# of 1,500 seeded random frames
SERVE_CROSS = [("phi4-mini-3.8b", 128, {"n_layers": 2}),
               ("mamba2-2.7b", 256, {"n_layers": 2}),
               ("recurrentgemma-9b", 256, {"n_layers": 4,
                                           "local_window": 128}),
               ("olmoe-1b-7b", 64, {"n_layers": 2}),
               ("whisper-base", 4, {})]


class _RoutingLog:
    """Records every MoE routing (`models.moe._route`) while active:
    the expert ids and the gap between the k-th and the (k+1)-th
    probability of each token, by device."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe._route
        self.ids = {"cuda": [], "cpu": []}
        self.gaps = {"cuda": [], "cpu": []}

        def logged(cfg, router, x_flat):
            weights, ids, probs = self.route(cfg, router, x_flat)
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            dev = x_flat.device.type
            self.ids[dev].append(ids.cpu())
            self.gaps[dev].append(float((top[:, -2] - top[:, -1]).min()))
            return weights, ids, probs
        moe._route = logged
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route


def serving_cross_check(dev, arch, prompt_len, overrides):
    """The same weights and tokens on the card and on the CPU in
    float32: prefill, then 8 decode steps fed the CPU's greedy tokens;
    every step's logits within 1e-3; for an MoE every routing's expert
    ids equal."""
    from repro_torch.models.params import tree_map
    model = _serving_model(arch, dtype="float32", **overrides)
    cfg = model.cfg
    cpu_params = model.init(SEED, device="cpu")
    params = tree_map(lambda t: t.to(dev), cpu_params)
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (2, prompt_len)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.normal(
            size=(2, cfg.enc_seq, cfg.d_model)), dtype=torch.float32)
    with _RoutingLog() as routing:
        _zero_counts()
        a, ca = model.prefill(params, {k: v.to(dev) for k, v in
                                       batch.items()}, pad_to=prompt_len + 8)
        launches = {k: v for k, v in _read_counts().items() if v}
        b, cb = model.prefill(cpu_params, batch, pad_to=prompt_len + 8)
        errs, agree, steps = [], 0, 0
        for step in range(9):
            a = a.cpu()
            err = float((a - b).abs().max())
            if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
                raise AssertionError(f"{arch}: card vs CPU logits differ at "
                                     f"step {step}: max abs {err}")
            errs.append(err)
            tok = torch.argmax(b, -1)
            agree += int((torch.argmax(a, -1) == tok).sum())
            steps += tok.numel()
            if step < 8:
                a, ca = model.decode(params, ca, tok.to(dev))
                b, cb = model.decode(cpu_params, cb, tok)
    out = {"arch": arch, **overrides, "dtype": "float32", "batch": 2,
           "prompt_len": prompt_len, "decode_steps": 8,
           "prefill_launches": launches, "max_abs_err": max(errs),
           "errs": errs, "greedy_agree": agree, "greedy_total": steps}
    if cfg.family == "moe":
        card, cpu = routing.ids["cuda"], routing.ids["cpu"]
        same = sum(int((x == y).sum()) for x, y in zip(card, cpu))
        total = sum(y.numel() for y in cpu)
        if len(card) != len(cpu) or len(cpu) != 9 * cfg.n_layers or (
                same != total):
            raise AssertionError(f"{arch}: routing ids agree in {same} of "
                                 f"{total} ({len(card)} card, {len(cpu)} "
                                 f"CPU routings)")
        out.update(routing_ids_equal=same, routing_ids_total=total,
                   min_topk_gap=min(routing.gaps["cpu"]),
                   min_topk_gap_card=min(routing.gaps["cuda"]))
    if cfg.family == "encdec":
        out["frames"] = list(batch["frames"].shape)
    return out


# arch, the config switch that sends its kernel's layer to the plain
# version: the bf16 kernels-vs-plain prefill check at the published widths
BF16_CHECK = [("phi4-mini-3.8b", "attn_impl", "flash_attention"),
              ("mamba2-2.7b", "ssm_impl", "ssd_scan"),
              ("olmoe-1b-7b", "attn_impl", "flash_attention"),
              ("dbrx-132b", "attn_impl", "flash_attention")]
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


# arch, depth override, batch, prompt length, warm-up prompt length and
# the kernel launches of one prefill (one generate) at full width; every
# flash and SSD launch there takes the tensor-core route, every RG-LRU
# launch the TMA ring. DBRX (132 B parameters) does not fit one 80 GB
# card: it serves at its published widths and 2 of its 40 layers.
# Whisper-base serves 8 clips of 1,500 (zero) frames and 4-token decoder
# prompts: 6 encoder, 6 decoder and 6 cross-attention launches
SERVE_FULL = [("phi4-mini-3.8b", {}, 4, 2048, 128, {"flash_attention": 32}),
              ("mamba2-2.7b", {}, 4, 2048, 256, {"ssd_scan": 64}),
              ("recurrentgemma-9b", {}, 4, 2048, 256,
               {"rglru_scan": 26, "flash_attention": 12}),
              ("olmoe-1b-7b", {}, 4, 2048, 256, {"flash_attention": 16}),
              ("dbrx-132b", {"n_layers": 2}, 4, 2048, 256,
               {"flash_attention": 2}),
              ("whisper-base", {}, 8, 4, 2, {"flash_attention": 18})]
MAIN_ROUTES = {"flash_attention": "wgmma", "ssd_scan": "mma_sync",
               "rglru_scan": "ring"}
CARBON_SERVE_ARCH = "phi4-mini-3.8b"    # the carbon-aware serving loop
DEVICE_BYTES = 80e9                     # one card's memory, the 80 GB


def _first_layer_aux(cfg, params, batch):
    """The first layer's MoE aux (``router_dropped``, ``lb_loss``) at the
    prefill's input: the layer run alone on the embedded prompts."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    tokens = batch["tokens"]
    x = T.embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    lp = T.layer(T.run_layers(cfg, params), 0)
    _, aux = T._layer_body(cfg, x, lp, positions, lambda q, k, v: L.attention(
        q, k, v, causal=True, impl=cfg.attn_impl))
    return {k: float(v) for k, v in aux.items()}


def serving_full_width(dev, arch, overrides, batch_size, prompt_len,
                       warmup_len, expected, then=None):
    """`ServeEngine.generate` of 32 greedy tokens after `batch_size`
    prompts of `prompt_len` random tokens at the published widths (and
    depth, unless `overrides` cut it), seeded random weights; then a
    torch.profiler breakdown of one prefill and one decode step.
    `then(engine)`, where given, runs last on the same engine; its result
    is returned beside."""
    from repro_torch.serve.engine import ServeEngine, throughput_tokens_per_s
    model = _serving_model(arch, **overrides)
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine = ServeEngine(model, device=dev).load(SEED)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (batch_size, prompt_len))
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
    if toks.shape != (batch_size, SERVE_NEW_TOKENS) or toks.min() < 0 or (
            toks.max() >= cfg.vocab_size):
        raise AssertionError(f"{arch}: generated tokens of shape "
                             f"{toks.shape} in [{toks.min()}, {toks.max()}]")
    peak = torch.cuda.max_memory_allocated(dev)
    if peak >= min(torch.cuda.get_device_properties(dev).total_memory,
                   DEVICE_BYTES):
        raise AssertionError(f"{arch}: peak memory {peak} B")
    tp = throughput_tokens_per_s(out["stats"])

    # where the time goes: one prefill and one decode step, profiled
    params = engine.prepared_params()
    batch = engine.prefill_batch(prompts)
    res = {}
    pre = _device_profile(lambda: res.update(zip(("logits", "cache"), (
        model.prefill(params, batch, pad_to=prompt_len + 1)))))
    logits = res["logits"]
    if tuple(logits.shape) != (batch_size, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: prefill logits are not finite of "
                             f"shape (B, V)")
    dec = _device_profile(lambda: model.decode(
        params, res["cache"], torch.argmax(logits, -1)))
    profile = {name: dict(zip(("wall_s", "device_s", "top"), prof))
               for name, prof in (("prefill", pre), ("decode_step", dec))}
    record = {"arch": arch, **overrides, "params": model.param_count(),
              "batch": batch_size, "prompt_len": prompt_len,
              "new_tokens": SERVE_NEW_TOKENS, "load_s": load_s,
              "prefill_s": out["stats"]["prefill_s"],
              "decode_s": out["stats"]["decode_s"], **tp,
              "max_memory_allocated": peak, "launches": launches,
              "route_launches": routes, "tokens_head": toks[:, :8].tolist(),
              "profile": profile}
    if cfg.family == "moe":
        record["layer0_aux"] = _first_layer_aux(cfg, params, batch)
    if cfg.family == "encdec":
        record["enc_frames_per_s"] = (batch_size * cfg.enc_seq
                                      / out["stats"]["prefill_s"])
    del res, logits, params, batch
    return (then(engine) if then is not None else None), record


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

    phase_s = {}        # wall seconds of each phase, for the time budget

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        return out

    kernels = {r["name"]: r for r in (
        timed("kernel_admission", admission_phase, dev),
        timed("kernel_flash", flash_phase, dev),
        timed("kernel_ssd", ssd_phase, dev),
        timed("kernel_rglru", rglru_phase, dev))}
    for name in ("flash_attention", "ssd_scan", "rglru_scan"):
        kernels[name]["sass"] = sass[name]
    bf16_check = [timed(f"bf16_{arch}", kernels_vs_plain_bf16, dev, arch,
                        switch, kernel)
                  for arch, switch, kernel in BF16_CHECK]
    _free_device_memory()
    flash_train = timed("flash_train", flash_train_phase, dev)
    kernels["flash_attention_bwd"] = {
        "name": "flash_attention_bwd", "sass": sass["flash_attention_bwd"],
        "route": "wgmma (bf16 at Dh 64 and 128)",
        **{k: flash_train[k] for k in ("shape", "bwd_kernel_ms", "bwd_ms",
                                       "bwd_bound_ms", "bwd_held",
                                       "bwd_512")}}
    _free_device_memory()
    scan_bwd = timed("scan_backward", scan_backward_phase, dev)
    _free_device_memory()
    cross = timed("cross_check", cross_check, dev)
    full = timed("full_width", full_width, dev)
    _free_device_memory()
    arithmetic = timed("device_arithmetic", device_arithmetic, dev)
    layered_cross = timed("layered_cross_check", layered_cross_check, dev)
    layered = timed("layered_full_width", layered_full_width, dev)
    _free_device_memory()
    scenario_cross = timed("scenario_cross_check", scenario_cross_check, dev)
    scenarios = timed("scenario_full_width", scenario_full_width, dev)
    _free_device_memory()
    custom = timed("custom_policy", custom_policy, dev)
    _free_device_memory()
    serve_cross = [timed(f"serving_cross_{arch}", serving_cross_check, dev,
                         arch, n, ov) for arch, n, ov in SERVE_CROSS]
    _free_device_memory()
    serve, cserve = [], None
    for arch, *shape in SERVE_FULL:
        then = (lambda e: carbon_serve(e, dev)) if arch == CARBON_SERVE_ARCH \
            else None
        follow, record = timed(f"serving_{arch}", serving_full_width, dev,
                               arch, *shape, then=then)
        serve.append(record)
        cserve = follow if follow is not None else cserve
        _free_device_memory()
    train_cross = []
    for arch, *shape in FAMILY_CROSS:
        train_cross.append(timed(f"train_cross_{arch}", train_cross_check,
                                 dev, arch, *shape))
        _free_device_memory()
    train = []
    for arch, *shape in FAMILY_FULL:
        train.append(timed(f"train_{arch}", train_full_width, dev, arch,
                           *shape))
        _free_device_memory()
    trainer = timed("carbon_trainer", carbon_trainer, dev)
    _free_device_memory()
    mesh_train = timed("mesh_train", mesh_train_phase, dev)
    _free_device_memory()
    mesh_serve = timed("mesh_serve", mesh_serve_phase, dev)
    smollm = f"{TRAIN_ARCH}__train_4k"
    dry = timed("dryrun", dryrun_phase, dev,
                {smollm: train[0]["step_time_s"]})
    _free_device_memory()
    roof = {f"{r['arch']}__{r['shape']}": r for r in dry["rows"]}
    if roof[smollm]["mfu"] != train[0]["mfu"]:
        raise AssertionError(f"roofline mfu {roof[smollm]['mfu']} != phase "
                             f"9's {train[0]['mfu']}")
    dry_mesh = timed("dryrun_mesh", dryrun_mesh_phase, dev, card)
    _free_device_memory()
    examples = timed("examples", examples_phase, dev)
    _free_device_memory()

    # launches: the count of each kernel over the main paths that run it
    by_path = {"placed_sweep": full["launches"],
               "placed_sweep_layered": layered["launches"],
               "scenario_matrix": scenarios["launches"],
               "custom_policy": custom["launches"],
               **{r["arch"]: r["launches"] for r in serve},
               f"carbon_serve_{CARBON_SERVE_ARCH}": cserve["launches"],
               **{f"train_{r['arch']}": r["launches"] for r in train},
               "carbon_trainer": trainer["launches"],
               "mesh_train": mesh_train["launches"],
               "mesh_serve": mesh_serve["launches"],
               "dryrun": dry["launches"],
               "dryrun_mesh": dry_mesh["launches"],
               "examples": examples["launches"]}
    for name, record in kernels.items():
        record["launches_by_path"] = {path: counts[name] for path, counts in
                                      by_path.items() if counts[name]}
        record["launches"] = sum(record["launches_by_path"].values())
        if not record["launches"]:
            raise AssertionError(f"{name} was not launched on a main path")
    flash = kernels["flash_attention"]
    flash["lse_launches"] = sum(
        r["route_launches"]["flash_attention"]["wgmma+lse"]
        for r in (*train, trainer))
    flash["train"] = {k: v for k, v in flash_train.items() if k != "checked"}
    flash["train_checked"] = flash_train["checked"]
    flash["max_abs_err_lse"] = max(c["lse_max_abs_err"]
                                   for c in flash_train["checked"])
    kernels["ssd_scan"]["backward"] = {
        k: v for k, v in scan_bwd["ssd_backward"].items() if k != "checked"}
    kernels["rglru_scan"]["backward"] = {
        k: v for k, v in scan_bwd["rglru_backward"].items() if k != "checked"}
    kernels = list(kernels.values())
    total_s = time.perf_counter() - t_start

    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "total_s": total_s, "phase_s": phase_s, "kernels": kernels,
              "cross_check": cross,
              "full_width": full, "device_arithmetic": arithmetic,
              "layered_cross_check": layered_cross,
              "layered_full_width": layered,
              "scenario_cross_check": scenario_cross,
              "scenario_full_width": scenarios, "custom_policy": custom,
              "serving_cross_check": serve_cross,
              "bf16_kernels_vs_plain": bf16_check, "serving": serve,
              "carbon_serve": cserve, "flash_train": flash_train,
              "train_cross_check": train_cross, "train_full_width": train,
              "carbon_trainer": trainer, "mesh_train": mesh_train,
              "mesh_serve": mesh_serve,
              "scan_backward": scan_bwd,
              "dryrun": {k: v for k, v in dry.items() if k != "table"},
              "dryrun_mesh": dry_mesh, "examples": examples}
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
    layered_summary = {k: v for k, v in layered.items() if k != "profile"}
    layered_summary["sweep_top"] = layered["profile"]["sweep"]["top"][:6]
    print(json.dumps({"build_s": build_s, "total_s": total_s,
                      "cross_check": cross, "full_width": summary,
                      "device_arithmetic": arithmetic,
                      "layered_cross_check": {
                          k: v for k, v in layered_cross.items()
                          if k not in ("a_all_four", "b_folded_in_scan")}
                      | {k: {"rows_parity": layered_cross[k]["rows_parity"]}
                         for k in ("a_all_four", "b_folded_in_scan")},
                      "layered_full_width": layered_summary,
                      "scenario_cross_check": {
                          k: v for k, v in scenario_cross.items()
                          if k != "cells"},
                      "scenario_full_width": {
                          "cells": scenarios["cells"],
                          "profile": {k: v for k, v in
                                      scenarios["profile"].items()
                                      if k != "top"},
                          "top": scenarios["profile"]["top"][:6]},
                      "custom_policy": custom, "carbon_serve": cserve,
                      "serving_cross_check": [
                          {k: v for k, v in r.items() if k != "errs"}
                          for r in serve_cross],
                      "bf16_kernels_vs_plain": bf16_check,
                      "serving": serve_summary}), flush=True)
    train_summary = []
    for r in train:
        row = {k: v for k, v in r.items() if k != "profile_microbatch"}
        row["profile_microbatch"] = {
            k: (v[:8] if k == "top" else v)
            for k, v in r["profile_microbatch"].items()}
        train_summary.append(row)
    print(json.dumps({"training": {
        "card": card, "phase_s": phase_s, "train_full_width": train_summary,
        "train_cross_check": train_cross,
        "flash_train": {k: v for k, v in flash_train.items()
                        if k != "checked"},
        "carbon_trainer": {k: v for k, v in trainer.items()
                           if k not in ("losses", "twin_losses")},
        "mesh_train": mesh_train, "mesh_serve": mesh_serve,
        "scan_backward": {k: {kk: vv for kk, vv in v.items()
                              if kk != "checked"}
                          for k, v in scan_bwd.items()}}}), flush=True)
    print(f"roofline of the single-card dry run ({card}):", flush=True)
    print(dry["table"], flush=True)
    print(json.dumps({"dryrun": {k: v for k, v in dry.items()
                                 if k not in ("rows", "table")},
                      "dryrun_mesh": dry_mesh,
                      "examples": examples}), flush=True)
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k not in ("checked", "sass",
                                                "train_checked")}
                                  for r in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
