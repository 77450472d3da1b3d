#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the repository root; needs one CUDA card and nvcc. Phases, each
raising on failure so the run exits non-zero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every kernel of the port from ``src/repro_torch/csrc``, one
     nvcc per source, all started together;
  3. kernel phase: each kernel against its plain PyTorch version on the
     card, on the same random inputs, at the main path's shapes; results
     must be exactly equal; both timed with CUDA events;
  4. cross-check: the placed sweep at 5,000 traces x 10 targets x 288
     epochs on the card and on the CPU: rows within 1e-9, plans equal;
  5. full width: the placed sweep of `benchmarks/figs.py::jax_sweep_scale`
     without its traffic, energy, elasticity and fault layers: 100,000
     Azure-like traces x 10 targets (N = 1,000,000 containers), 288
     five-minute epochs, regions PL/NL/CAISO at capacity 60,000 each,
     CarbonContainerPolicy("energy"), through `SweepSpec(...).run()`.
     The kernels' launch counters are zeroed just before and read just
     after; the run must have launched each kernel of the path.

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
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
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


def kernel_phase(dev):
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
        checked.append((N, R))
    # time at the main path's shape: the planner's N = 100k, R = 3
    args = _admission_inputs(100_000, 3, 0, dev)
    kernel = lambda: admission_round(*args)            # noqa: E731
    plain = lambda: admission_round_torch(*args)       # noqa: E731
    ms = _median_ms(kernel, head_start_cycles=2_000_000)
    plain_ms = _median_ms(plain, head_start_cycles=20_000_000)
    call_ms = _median_ms(kernel)
    plain_call_ms = _median_ms(plain)
    N, R = args[0].shape
    # each input read once, each output written once
    nbytes = (N * R * 8 + N * (4 + 1 + 4 + 4) + R * 4) + (N * 8 + R * 4)
    return {"name": "admission_round", "route": "cuda",
            "source": "src/repro_torch/csrc/admission_round.cu",
            "replaces": "src/repro/cluster/placement_pallas.py:120",
            "exact": True, "max_abs_err": 0, "checked": checked,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": nbytes, "library_ms": None}


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

    t0 = time.perf_counter()
    libs = cuda_build.build(["admission_round"])
    build_s = time.perf_counter() - t0
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            print(f"[{name}] {log.read_text().strip()}", flush=True)

    kernels = [kernel_phase(dev)]
    cross = cross_check(dev)
    full = full_width(dev)
    kernels[0]["launches"] = full["admission_launches"]

    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "kernels": kernels, "cross_check": cross, "full_width": full}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    summary = {k: v for k, v in full.items() if k not in ("rows", "profile")}
    summary["sweep_device_s"] = full["profile"]["sweep"]["device_s"]
    summary["plan_device_s"] = full["profile"]["plan"]["device_s"]
    print(json.dumps({"build_s": build_s, "cross_check": cross,
                      "full_width": summary}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
