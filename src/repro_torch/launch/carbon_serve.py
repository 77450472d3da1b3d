"""Carbon-aware serving: a request queue with minutes-scale load swings
(the paper's workload-intensity argument) served under a carbon cap; the
port's `examples/carbon_serve.py`.

The scheduler feeds queue-implied demand into the Carbon Container
policy; the policy answers with slice + duty decisions; the scheduler
serves at the allowed rate of a decode capacity measured on the engine.

    PYTHONPATH=src python -m repro_torch.launch.carbon_serve --device cpu

``--arch`` (default smollm-135m), ``--smoke`` (default true: the smoke
config; ``--smoke false`` is the published widths, for the card),
``--device`` (default cuda) and ``--intervals`` (default 96: 8 hours of
5-minute intervals).
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.carbon.intensity import TraceProvider
from repro_torch.cluster.slices import paper_family
from repro_torch.config import parse_cli
from repro_torch.configs import get_arch
from repro_torch.core.container import ContainerState, PlantModel
from repro_torch.core.policy import CarbonContainerPolicy
from repro_torch.models.api import get_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import CarbonAwareScheduler, poisson_arrivals

TARGET_G_PER_H = 45.0
INTERVAL_S = 300.0


def calibrate(engine: ServeEngine) -> float:
    """Decode capacity at duty 1.0: tokens over the device-synced decode
    time of 4 new tokens after 4 prompts of 8 tokens (the engine's stats
    start from 0)."""
    engine.stats = dict.fromkeys(engine.stats, 0)
    prompts = np.zeros((4, 8), np.int32)
    engine.generate(prompts, 4)
    return engine.stats["decode_tokens"] / max(engine.stats["decode_s"], 1e-9)


def control_loop(tok_s: float, intervals: int = 96) -> tuple:
    """The example's loop: CAISO over 48 h (seed 3), a 45 g/h target,
    5-minute intervals, Poisson arrivals of 32-token requests whose rate
    triples for intervals 30-59. Returns (records, scheduler): one record
    per interval (t, c, demand, slice, duty, rate, served, backlog, kind)
    and the scheduler, which holds the completed requests."""
    fam = paper_family()
    policy = CarbonContainerPolicy(variant="energy")
    state = ContainerState(slice_idx=fam.baseline_idx)
    carbon = TraceProvider.for_region("CAISO", hours=48, seed=3)
    sch = CarbonAwareScheduler(capacity_tok_s=tok_s)
    target, interval = TARGET_G_PER_H, INTERVAL_S
    records = []
    for n in range(intervals):
        t = n * interval
        lam = 0.03 * (3.0 if 30 <= n < 60 else 1.0)
        for a in poisson_arrivals(lam, interval, seed=n):
            sch.offer(t + a, max_new=32)
        c = carbon.intensity(t)
        demand = min(sch.demand(interval), 4.0)
        state.observe_demand(demand)
        action = policy.decide(fam, state, demand, c, target, 0.05)
        if action.kind == "migrate":
            state.slice_idx = action.target_slice
            state.dwell = 0
        state.duty = action.duty if action.kind in ("stay", "migrate", "resume") else 0.0
        state.suspended = action.kind == "suspend"
        state.dwell += 1
        s = fam[state.slice_idx]
        res = sch.run_interval(state.duty if not state.suspended else 0.0,
                               s.multiple, interval)
        served_util = min(res["util"], s.multiple)
        power = 0.0 if state.suspended else s.power.power(
            min(served_util / s.multiple, 1.0))
        rate = PlantModel.rate(power, c)
        records.append({"t": t, "c": c, "demand": demand, "slice": s.name,
                        "duty": state.duty, "rate": rate,
                        "served": res["served"], "backlog": res["backlog"],
                        "kind": action.kind})
    return records, sch


def summary(records: list, sch: CarbonAwareScheduler) -> dict:
    """The example's summary: the average C(t) (its emissions over its
    hours, summed interval by interval) and the latency statistics."""
    emissions, hours_total = 0.0, 0.0
    for r in records:
        emissions += r["rate"] * INTERVAL_S / 3600.0
        hours_total += INTERVAL_S / 3600.0
    return {"avg_rate": emissions / hours_total, **sch.latency_stats()}


def main(argv=None) -> int:
    args = parse_cli(argv if argv is not None else sys.argv[1:])
    spec = get_arch(args.get("arch", "smollm-135m"))
    cfg = spec.smoke if args.get("smoke", "true") != "false" else spec.full
    engine = ServeEngine(get_model(cfg), device=args.get("device", "cuda"))
    engine.load()
    tok_s = calibrate(engine)
    print(f"decode capacity {tok_s:.0f} tok/s; C_target {TARGET_G_PER_H} "
          f"g/hr\n")
    print(f"  {'hour':>5s} {'c g/kWh':>8s} {'demand':>7s} {'slice':>6s} "
          f"{'duty':>5s} {'C g/hr':>7s} {'backlog':>7s}")
    records, sch = control_loop(tok_s, int(args.get("intervals", 96)))
    for n, r in enumerate(records):
        if n % 8 == 0:
            print(f"  {r['t']/3600:5.1f} {r['c']:8.0f} {r['demand']:7.2f} "
                  f"{r['slice']:>6s} {r['duty']:5.2f} {r['rate']:7.1f} "
                  f"{r['backlog']:7d}")
    s = summary(records, sch)
    print(f"\navg C(t) = {s['avg_rate']:.1f} g/hr (target "
          f"{TARGET_G_PER_H}); served {s['n']} requests, p95 latency "
          f"{s['p95_s']:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
