#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the repository root; needs one CUDA card and nvcc. Phases, each
raising on failure so the run exits non-zero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
     TF32 off for float32 matmuls (the card-vs-CPU checks depend on it);
  2. build every kernel of the port from ``src/repro_torch/csrc``, one
     nvcc per source, all started together;
  3. kernel phase: each kernel against its plain PyTorch version on the
     card, on the same random inputs, at the main paths' shapes (the
     admission round exactly; flash attention within 2e-5 in float32 and
     2e-2 in bfloat16); both timed with CUDA events at the main path's
     shape, beside one PyTorch library call where one computes the same
     function, and the least time the card could take (`bound_ms`);
  4. sweep cross-check: the placed sweep at 5,000 traces x 10 targets x
     288 epochs on the card and on the CPU: rows within 1e-9, plans equal;
  5. sweep at full width: the placed sweep of
     `benchmarks/figs.py::jax_sweep_scale` without its traffic, energy,
     elasticity and fault layers: 100,000 Azure-like traces x 10 targets
     (N = 1,000,000 containers), 288 five-minute epochs, regions
     PL/NL/CAISO at capacity 60,000 each, CarbonContainerPolicy("energy"),
     through `SweepSpec(...).run()`;
  6. serving cross-check: phi4-mini-3.8b's widths at 2 layers in float32,
     the same weights on the card and on the CPU, batch 2 x 128-token
     prompts, then 8 decode steps fed the same tokens: every step's
     logits within 1e-3;
  7. serving at full width: phi4-mini-3.8b (32 layers, d_model 3072,
     200,064-token vocabulary), seeded random weights on the card,
     `ServeEngine.generate` of 32 greedy tokens after 4 prompts of 2,048
     random tokens, then a torch.profiler breakdown of one prefill and of
     one decode step.

Phases 5 and 7 are the main paths: each kernel's launch counter is set to
0 just before its path and read just after; the path must have launched
its kernel (2*R*T admission launches; one flash launch per layer).

Prints the nvidia-smi line, one line of phase results, the ``kernels``
JSON line, and last ``{"ok": true, "device": {...}}``. The full record
goes to ``chiprun_out/chip_smoke.json``.
"""
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
SERVE_ARCH = "phi4-mini-3.8b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW_TOKENS = 4, 2048, 32
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores, same
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
                   tolerance, kernel_head_start, plain_head_start):
    """One kernel's record, the same keys for every kernel: its time and
    its plain version's (CUDA events, median; with a head start so the
    device work alone is timed, and as one call from the host), one
    library call's time where `library` is given, and the bound: the
    larger of the bytes that must move (each input read once, each output
    written once) over HBM bandwidth and the operations over the peak
    rate for their type."""
    ms = _median_ms(kernel, head_start_cycles=kernel_head_start)
    plain_ms = _median_ms(plain, head_start_cycles=plain_head_start)
    library_ms = (_median_ms(library, head_start_cycles=kernel_head_start)
                  if library is not None else None)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / peak_flops * 1e3 if flops else 0.0
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": max_abs_err, "tolerance": tolerance,
            "checked": checked, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "call_ms": _median_ms(kernel), "plain_call_ms": _median_ms(plain),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "operations" if op_ms > byte_ms else "bytes",
            "bytes": nbytes, "flops": flops}


def admission_phase(dev):
    from repro_torch.cluster.placement_kernel import (admission_round,
                                                      admission_round_torch)
    checked = []
    for N, R, seed in ((100_000, 3, 0), (12_345, 5, 1), (100_000, 3, 2)):
        args = _admission_inputs(N, R, seed, dev)
        got = admission_round(*args)
        want = admission_round_torch(*args)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in
                  zip(got, want))
        if err != 0:
            raise AssertionError(f"admission_round differs from its plain "
                                 f"version at N={N}, R={R}: max abs {err}")
        if not bool((want[2] > args[5]).any()):
            raise AssertionError(f"kernel inputs at N={N}, R={R} are not "
                                 f"contended")
        checked.append({"N": N, "R": R, "max_abs_err": err})
    # time at the main path's shape: the planner's N = 100k, R = 3
    args = _admission_inputs(100_000, 3, 0, dev)
    N, R = args[0].shape
    # each input read once, each output written once
    nbytes = (N * R * 8 + N * (4 + 1 + 4 + 4) + R * 4) + (N * 8 + R * 4)
    return _kernel_record(
        "admission_round", "src/repro_torch/csrc/admission_round.cu",
        "src/repro/cluster/placement_pallas.py:120",
        lambda: admission_round(*args), lambda: admission_round_torch(*args),
        None, nbytes=nbytes, flops=0, peak_flops=None, checked=checked,
        max_abs_err=0, tolerance="exact", kernel_head_start=2_000_000,
        plain_head_start=20_000_000)


# B, S, Hq, Hkv, Dh, causal, window: tests/test_kernels.py's ATTN_CASES,
# then SmolLM-135M's prefill shape; the main path's shape comes last
FLASH_CASES = [(2, 128, 4, 2, 32, True, 0), (1, 64, 2, 1, 16, True, 24),
               (2, 128, 4, 4, 64, False, 0), (1, 96, 8, 2, 32, True, 0),
               (2, 512, 9, 3, 64, True, 0)]
FLASH_MAIN = (4, 2048, 24, 8, 128, True, 0)      # phi4-mini prefill, bf16
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(case, dtype, dev, seed):
    B, S, Hq, Hkv, Dh = case[:5]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(B, S, h, Dh, generator=gen, device=dev).to(dtype)
                 for h in (Hq, Hkv, Hkv))


def flash_phase(dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    checked = []
    runs = [(c, dt) for c in FLASH_CASES for dt in FLASH_TOL]
    runs.append((FLASH_MAIN, torch.bfloat16))
    for i, (case, dtype) in enumerate(runs):
        causal, window = case[5], case[6]
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
                        "max_abs_err": err, "tol": tol})
    B, S, Hq, Hkv, Dh, causal, window = FLASH_MAIN
    q, k, v = _qkv(FLASH_MAIN, torch.bfloat16, dev, seed=len(runs) - 1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                          enable_gqa=True).transpose(1, 2)
    library_err = float((sdpa.float() - flash_attention_torch(
        q, k, v).float()).abs().max())
    pairs = S * (S + 1) // 2                   # causal (q, kv) pairs
    record = _kernel_record(
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:78",
        lambda: flash_attention(q, k, v, causal=causal, window=window),
        lambda: flash_attention_torch(q, k, v, causal=causal, window=window),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        nbytes=2 * (2 * B * S * Hq * Dh + 2 * B * S * Hkv * Dh),
        flops=4 * B * Hq * Dh * pairs, peak_flops=BF16_FLOP_PER_S,
        checked=checked, max_abs_err=max(c["max_abs_err"] for c in checked),
        tolerance="2e-5 float32, 2e-2 bfloat16 (abs and rel)",
        kernel_head_start=2_000_000, plain_head_start=20_000_000)
    record["shape"] = {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "Dh": Dh,
                       "dtype": "bfloat16", "causal": causal}
    record["library"] = ("torch.nn.functional.scaled_dot_product_attention"
                         "(is_causal=True, enable_gqa=True)")
    record["library_max_abs_err"] = library_err
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
    from repro_torch.cluster.placement_kernel import admission_round
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
    admission_round.launches = 0
    t0 = time.perf_counter()
    res = spec.run()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = admission_round.launches
    if launches != 2 * R * T:
        raise AssertionError(f"admission_round launched {launches} times "
                             f"on the main path, expected 2*R*T = "
                             f"{2 * R * T}")
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
            "over_capacity_epochs": over, "admission_launches": launches,
            "plan_migrations": int(plan.migrations.sum()),
            "rows": res.rows, "profile": profile}


def _serving_model(n_layers=0, dtype=None):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.api import get_model
    cfg = get_arch(SERVE_ARCH).full
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                              dtype=dtype or cfg.dtype)
    return get_model(cfg)


def serving_cross_check(dev):
    """phi4-mini's widths at 2 layers in float32: the same weights and
    tokens on the card and on the CPU, prefill then 8 decode steps fed
    the CPU's greedy tokens."""
    from repro_torch.models.params import tree_map
    model = _serving_model(n_layers=2, dtype="float32")
    cpu_params = model.init(SEED, device="cpu")
    params = tree_map(lambda t: t.to(dev), cpu_params)
    prompts = np.random.default_rng(SEED).integers(
        0, model.cfg.vocab_size, (2, 128))
    tokens = torch.as_tensor(prompts)
    a, ca = model.prefill(params, {"tokens": tokens.to(dev)}, pad_to=136)
    b, cb = model.prefill(cpu_params, {"tokens": tokens}, pad_to=136)
    errs, agree, steps = [], 0, 0
    for step in range(9):
        a = a.cpu()
        err = float((a - b).abs().max())
        if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
            raise AssertionError(f"card vs CPU logits differ at step {step}: "
                                 f"max abs {err}")
        errs.append(err)
        tok = torch.argmax(b, -1)
        agree += int((torch.argmax(a, -1) == tok).sum())
        steps += tok.numel()
        if step < 8:
            a, ca = model.decode(params, ca, tok.to(dev))
            b, cb = model.decode(cpu_params, cb, tok)
    return {"arch": SERVE_ARCH, "n_layers": 2, "dtype": "float32",
            "batch": 2, "prompt_len": 128, "decode_steps": 8,
            "max_abs_err": max(errs), "errs": errs,
            "greedy_agree": agree, "greedy_total": steps}


def serving_full_width(dev):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serve.engine import ServeEngine, throughput_tokens_per_s
    model = _serving_model()
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine = ServeEngine(model, device=dev).load(SEED)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
    engine.generate(prompts[:, :128], 2)          # warm-up (cuBLAS, caches)
    engine.stats = dict.fromkeys(engine.stats, 0)

    flash_attention.launches = 0
    out = engine.generate(prompts, SERVE_NEW_TOKENS, duty=1.0)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"flash_attention launched {launches} times on "
                             f"the serving path, expected one per layer = "
                             f"{cfg.n_layers}")
    toks = out["tokens"]
    if toks.shape != (SERVE_BATCH, SERVE_NEW_TOKENS) or toks.min() < 0 or (
            toks.max() >= cfg.vocab_size):
        raise AssertionError(f"generated tokens of shape {toks.shape} in "
                             f"[{toks.min()}, {toks.max()}]")
    peak = torch.cuda.max_memory_allocated(dev)
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
        raise AssertionError("prefill logits are not finite of shape (B, V)")
    dec = _device_profile(lambda: model.decode(
        params, res["cache"], torch.argmax(logits, -1)))
    profile = {name: dict(zip(("wall_s", "device_s", "top"), prof))
               for name, prof in (("prefill", pre), ("decode_step", dec))}
    return {"arch": SERVE_ARCH, "params": model.param_count(),
            "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
            "new_tokens": SERVE_NEW_TOKENS, "load_s": load_s,
            "prefill_s": out["stats"]["prefill_s"],
            "decode_s": out["stats"]["decode_s"], **tp,
            "max_memory_allocated": peak, "flash_launches": launches,
            "tokens_head": toks[:, :8].tolist(), "profile": profile}


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

    t0 = time.perf_counter()
    libs = cuda_build.build(["admission_round", "flash_attention"])
    build_s = time.perf_counter() - t0
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            print(f"[{name}] {log.read_text().strip()}", flush=True)

    kernels = [admission_phase(dev), flash_phase(dev)]
    cross = cross_check(dev)
    full = full_width(dev)
    kernels[0]["launches"] = full["admission_launches"]
    torch.cuda.empty_cache()
    serve_cross = serving_cross_check(dev)
    serve = serving_full_width(dev)
    kernels[1]["launches"] = serve["flash_launches"]

    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "kernels": kernels, "cross_check": cross, "full_width": full,
              "serving_cross_check": serve_cross, "serving": serve}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    summary = {k: v for k, v in full.items() if k not in ("rows", "profile")}
    summary["sweep_device_s"] = full["profile"]["sweep"]["device_s"]
    summary["plan_device_s"] = full["profile"]["plan"]["device_s"]
    serve_summary = {k: v for k, v in serve.items() if k != "profile"}
    for name, prof in serve["profile"].items():
        serve_summary[name] = {"wall_s": prof["wall_s"],
                               "device_s": prof["device_s"],
                               "top": prof["top"][:6]}
    print(json.dumps({"build_s": build_s, "cross_check": cross,
                      "full_width": summary,
                      "serving_cross_check": {k: v for k, v in
                                              serve_cross.items()
                                              if k != "errs"},
                      "serving": serve_summary}), flush=True)
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k != "checked"} for r in kernels]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
