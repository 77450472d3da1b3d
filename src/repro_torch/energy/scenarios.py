"""Scenario stress matrix: named supply/fleet stress cells over the sweep
(the port's `repro.energy.scenarios`).

Each cell is a named scenario — fleet churn (arrivals/departures), grid
outages, correlated intensity shocks, migration failures injected
through `repro_torch.distributed.fault`, straggler-delayed
suspend/resume via `repro_torch.distributed.stragglers`, demand bursts
replayed through `repro_torch.workload.replay`, and signal-plane faults
(telemetry blackout, flapping carbon feed, migration storms) injected
through `repro_torch.robustness` — executed as one `SweepSpec` sweep
with the virtual energy supply enabled (folded into the fleet scan on
the device), on every device asked for, with invariant checks:

  - energy conservation: solar_used + battery + grid == supplied
    (max per-epoch error <= 1e-6 W);
  - zero virtual-cap violations (demand never draws past the supply);
  - battery state of charge within [0, capacity];
  - with two devices, card <-> CPU parity <= 1e-6 on every aggregate
    row metric, including the energy accounting (`backend_parity`, the
    reference's name for its fleet <-> jax check).

Every scenario reuses the same solar/battery configuration and the same
array shapes; scenario variation lives entirely in the event tensors
and the demand shaping. The masks and the shaped demand are host numpy,
as in the reference; the sweep moves the demand to the device once.

    PYTHONPATH=src python -m repro_torch.energy.scenarios --devices cpu

runs the matrix on the CPU (``--devices cuda,cpu`` holds the card
against it; ``--fast`` is T = 96, n = 8) and exits non-zero if any
invariant fails. `chip_smoke.py` runs it on the card.
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.cluster.placement import PlacementConfig
from repro_torch.cluster.slices import paper_family
from repro_torch.core.policy import CarbonAgnosticPolicy, CarbonContainerPolicy
from repro_torch.core.simulator import SimConfig
from repro_torch.core.spec import SweepResult, SweepSpec
from repro_torch.distributed.fault import FailureInjector, HeartbeatMonitor
from repro_torch.distributed.stragglers import StragglerDetector
from repro_torch.energy.supply import EnergyConfig, GridEventConfig
from repro_torch.robustness import (CarbonFeedFaults, FaultPlan,
                                    MigrationFaults, PowerTelemetryFaults)
from repro_torch.workload.replay import ReplayHarness

CONSERVATION_TOL_W = 1e-6
PARITY_TOL = 1e-6


@dataclass
class Scenario:
    """One stress cell: an event layer plus optional demand shaping.

    `shape_demand(traces, interval_s)` returns the stressed (T, n)
    demand matrix (and may record scenario metadata in `meta`).
    `faults` (a `repro_torch.robustness.FaultPlan`) additionally degrades the
    signal plane — stale/missing carbon telemetry, power-meter gaps,
    failed migrations — through the sweep's fault injection."""
    name: str
    description: str
    energy: EnergyConfig
    shape_demand: Optional[Callable] = None
    meta: dict = field(default_factory=dict)
    faults: Optional[object] = None


# ---------------------------------------------------------------------------
# Demand-shaping stressors (each drives one dormant subsystem)
# ---------------------------------------------------------------------------

def churn_mask(T: int, n: int, seed: int = 11) -> np.ndarray:
    """Fleet churn: a third of the fleet arrives late, a third departs
    early (containers outside their [arrival, departure) window demand
    nothing)."""
    rng = np.random.default_rng(seed)
    arrive = np.zeros(n, dtype=int)
    depart = np.full(n, T, dtype=int)
    late = rng.choice(n, size=n // 3, replace=False)
    arrive[late] = rng.integers(1, max(2, T // 4), size=late.size)
    rest = np.setdiff1d(np.arange(n), late)
    early = rng.choice(rest, size=n // 3, replace=False)
    depart[early] = rng.integers(3 * T // 4, T, size=early.size)
    t = np.arange(T)[:, None]
    return ((t >= arrive[None, :]) & (t < depart[None, :])).astype(float)


def failure_mask(T: int, n: int, interval_s: float,
                 n_hosts: int = 8) -> tuple:
    """Migration failures via `repro_torch.distributed.fault`: hosts die on the
    `FailureInjector` schedule and stop heartbeating; the clock-injected
    `HeartbeatMonitor` flags them after its timeout, at which point the
    checkpoint-restore path brings their containers back (elastic
    recovery). Containers on a dead host serve nothing from the failure
    until one epoch after detection. Returns (mask, meta)."""
    hosts = [f"h{i}" for i in range(n_hosts)]
    host_of = np.arange(n) % n_hosts
    injector = FailureInjector(schedule={T // 3: 2, (2 * T) // 3: 1})
    now = [0.0]
    monitor = HeartbeatMonitor(timeout_s=2.5 * interval_s,
                               clock=lambda: now[0])
    mask = np.ones((T, n))
    live = list(hosts)
    pending: dict = {}                      # host -> failure epoch
    episodes: list = []
    for t in range(T):
        now[0] = t * interval_s
        lost = injector.check(t)
        if lost:
            for h in live[-lost:]:
                pending[h] = t
            live = live[:-lost]
        for h in live:
            monitor.beat(h)
        # a pending host serves nothing this epoch (including the
        # detection epoch — restore lands at its end)
        for h in pending:
            mask[t, host_of == hosts.index(h)] = 0.0
        for h in monitor.dead_hosts():
            if h in pending:                # detected: checkpoint restore
                episodes.append({"host": h, "failed_at": pending.pop(h),
                                 "detected_at": t})
                live.append(h)
    meta = {"failed_at": {e["host"]: e["failed_at"] for e in episodes},
            "detected_at": {e["host"]: e["detected_at"] for e in episodes},
            "detect_delay_epochs": {e["host"]: e["detected_at"]
                                    - e["failed_at"] for e in episodes},
            "episodes": episodes}
    return mask, meta


def straggler_mask(T: int, n: int, seed: int = 13) -> tuple:
    """Straggler-delayed suspend/resume via `repro_torch.distributed.stragglers`:
    one container's synchronous steps slow by `factor` mid-trace, cutting
    its served demand to 1/factor until the `StragglerDetector` fires
    "migrate" (the mitigation path), after which it runs at full speed
    on the new slice. Returns (mask, meta)."""
    rng = np.random.default_rng(seed)
    base = np.clip(rng.normal(1.0, 0.03, size=T), 0.9, 1.1)
    onset, factor, col = T // 3, 2.6, 0
    det = StragglerDetector()
    mask = np.ones((T, n))
    migrated_at = None
    for t in range(T):
        slow = migrated_at is None and t >= onset
        act = det.observe(base[t] * (factor if slow else 1.0))
        if slow:
            mask[t, col] = 1.0 / factor
            if act == "migrate":
                migrated_at = t
    meta = {"onset": onset, "migrated_at": migrated_at,
            "straggle_epochs": (migrated_at - onset + 1
                                if migrated_at is not None else T - onset)}
    return mask, meta


def burst_profile(T: int, interval_s: float) -> tuple:
    """Demand burst replayed through `repro_torch.workload.replay`: a midday
    burst multiplier is driven through the `ReplayHarness` against a
    quantized actuator (1/64 duty steps) and the *achieved* profile is
    what stresses the fleet — the harness verifies the tracking bound
    on the way. Returns (multiplier (T,), meta)."""
    t = np.arange(T)
    target = 1.0 + 1.2 * np.exp(-((t - 0.55 * T) / (0.04 * T + 1e-9)) ** 2)
    harness = ReplayHarness(interval_s=interval_s, tolerance=0.05)
    rep = harness.replay(target, lambda u: round(u * 64.0) / 64.0)
    meta = {"ma_max_err": rep["ma_max_err"],
            "within_tolerance": rep["within_tolerance"]}
    return np.asarray(rep["achieved"]), meta


# ---------------------------------------------------------------------------
# The matrix
# ---------------------------------------------------------------------------

def build_matrix(T: int, interval_s: float = 300.0) -> list:
    """The named scenario cells (shared solar/battery; events + demand
    shaping vary)."""
    calm = GridEventConfig()

    def churn(traces, dt):
        return traces * churn_mask(*traces.shape), {}

    def failures(traces, dt):
        mask, meta = failure_mask(traces.shape[0], traces.shape[1], dt)
        return traces * mask, meta

    def stragglers(traces, dt):
        mask, meta = straggler_mask(*traces.shape)
        return traces * mask, meta

    def burst(traces, dt):
        mult, meta = burst_profile(traces.shape[0], dt)
        return traces * mult[:, None], meta

    return [
        Scenario("baseline", "steady fleet, calm grid", EnergyConfig()),
        Scenario("fleet_churn", "arrivals/departures churn the fleet",
                 EnergyConfig(events=calm), churn),
        Scenario("grid_outage", "regional grid outages force "
                 "solar/battery islanding",
                 EnergyConfig(events=GridEventConfig(
                     outages=((0, T // 4, max(3, T // 24)),
                              (1, T // 2, max(3, T // 18)))))),
        Scenario("intensity_shock", "correlated cross-region intensity "
                 "spike + one regional shock",
                 EnergyConfig(events=GridEventConfig(
                     shocks=((-1, int(0.4 * T), max(6, T // 12), 2.5),
                             (2, int(0.7 * T), max(6, T // 16), 1.8))))),
        Scenario("migration_failures", "hosts fail mid-sweep; heartbeat "
                 "detection + checkpoint restore",
                 EnergyConfig(events=calm), failures),
        Scenario("stragglers", "straggler-delayed suspend/resume until "
                 "mitigation migrates the job",
                 EnergyConfig(events=calm), stragglers),
        Scenario("demand_burst", "replayed demand burst at solar peak",
                 EnergyConfig(events=calm), burst),
        Scenario("telemetry_blackout", "carbon feed goes dark for a "
                 "stretch + the power meter drops epochs; the "
                 "degradation ladder rides hold -> prior -> floor",
                 EnergyConfig(events=calm),
                 faults=FaultPlan(
                     carbon=CarbonFeedFaults(
                         blackouts=((-1, T // 3, max(4, T // 8)),)),
                     power=PowerTelemetryFaults(
                         gaps=((T // 2, max(3, T // 16)),)),
                     seed=23)),
        Scenario("flapping_feed", "carbon telemetry flaps: random "
                 "dropouts + a noisy window degrade every controller "
                 "decision",
                 EnergyConfig(events=calm),
                 faults=FaultPlan(
                     carbon=CarbonFeedFaults(
                         dropout_prob=0.25,
                         noise_windows=((-1, T // 4, max(6, T // 6),
                                         0.2),)),
                     seed=29)),
        Scenario("migration_storm", "planned migrations fail in bulk; "
                 "capped backoff must keep retries from thrashing",
                 EnergyConfig(events=calm),
                 faults=FaultPlan(
                     migration=MigrationFaults(fail_prob=0.5,
                                               backoff_base=1,
                                               backoff_cap=8),
                     seed=31)),
    ]


def _shared_inputs(T: int, n_tr: int, seed: int = 5) -> tuple:
    """Deterministic base demand + (T, R) region-intensity matrix shared
    by every cell."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    diurnal = 0.9 + 0.5 * np.sin(2 * np.pi * t / max(T, 1))[:, None]
    traces = np.clip(diurnal + rng.normal(0.0, 0.2, size=(T, n_tr)),
                     0.05, 2.0)
    phases = (0.0, 1.7, 3.1)
    regions = np.stack([230 + 160 * np.sin(2 * np.pi * t / max(T, 1) + p)
                        for p in phases], axis=1) + 40.0
    return traces, regions


def run_scenario(sc: Scenario, T: int = 288, n_tr: int = 24,
                 targets=(40.0, 80.0), devices=("cuda",)) -> dict:
    """Run one cell on every device and evaluate the invariants. The
    result also carries each device's `sweep_s` (wall time of
    `SweepSpec.run`, which ends in host copies of the results)."""
    traces, regions = _shared_inputs(T, n_tr)
    dt = 300.0
    if sc.shape_demand is not None:
        traces, meta = sc.shape_demand(traces, dt)
        sc.meta.update(meta)
    policies = {"cc": lambda: CarbonContainerPolicy(),
                "agnostic": lambda: CarbonAgnosticPolicy()}
    results: dict = {}
    sweep_s: dict = {}
    for device in devices:
        spec = SweepSpec(policies=policies, family=paper_family(),
                         traces=traces, targets=list(targets),
                         sim=SimConfig(target_rate=0.0, interval_s=dt),
                         placement=PlacementConfig(capacity=max(2, n_tr)),
                         regions=regions, energy=sc.energy,
                         faults=sc.faults, device=device)
        t0 = time.perf_counter()
        results[device] = spec.run()
        sweep_s[device] = time.perf_counter() - t0
    first: SweepResult = results[devices[0]]
    checks = {
        "conservation_max_err_w": float(
            first.col("energy_conservation_max_err_w").max()),
        "cap_violations": float(first.col("energy_cap_violations").max()),
        "soc_violations": float(first.col("energy_soc_violations").max()),
    }
    if len(devices) > 1:
        checks["backend_parity"] = max(
            results[devices[0]].parity(results[d]) for d in devices[1:])
    ok = (checks["conservation_max_err_w"] <= CONSERVATION_TOL_W
          and checks["cap_violations"] == 0
          and checks["soc_violations"] == 0
          and checks.get("backend_parity", 0.0) <= PARITY_TOL)
    return {"name": sc.name, "ok": ok, "checks": checks,
            "meta": sc.meta, "results": results, "sweep_s": sweep_s,
            "unmet_frac": float(first.col("energy_unmet_frac").max()),
            "outage_epochs": float(first.col("energy_outage_epochs").max())}


def run_matrix(T: int = 288, n_tr: int = 24, targets=(40.0, 80.0),
               devices=("cuda",)) -> list:
    return [run_scenario(sc, T=T, n_tr=n_tr, targets=targets,
                         devices=devices)
            for sc in build_matrix(T)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run the energy scenario stress matrix")
    ap.add_argument("--fast", action="store_true",
                    help="small shapes (T=96, n=8) for quick checks")
    ap.add_argument("--devices", default="cuda",
                    help="comma-separated devices (default cuda); with "
                         "two, the first is held against the second")
    args = ap.parse_args(argv)
    T, n_tr = (96, 8) if args.fast else (288, 24)
    devices = tuple(d for d in args.devices.split(",") if d)
    rows = run_matrix(T=T, n_tr=n_tr, devices=devices)
    wid = max(len(r["name"]) for r in rows)
    print(f"{'scenario':<{wid}}  ok    conserv(W)  capv  socv  parity    "
          f"unmet  outages")
    bad = 0
    for r in rows:
        c = r["checks"]
        bad += not r["ok"]
        print(f"{r['name']:<{wid}}  {'ok' if r['ok'] else 'FAIL':4}  "
              f"{c['conservation_max_err_w']:.2e}  "
              f"{int(c['cap_violations']):4d}  {int(c['soc_violations']):4d}"
              f"  {c.get('backend_parity', 0.0):.2e}  "
              f"{r['unmet_frac']:.3f}  {int(r['outage_epochs']):d}")
    if bad:
        print(f"{bad} scenario(s) violated invariants")
        return 1
    print(f"all {len(rows)} scenarios hold: conservation <= "
          f"{CONSERVATION_TOL_W} W, zero cap/SoC violations, device "
          f"parity <= {PARITY_TOL}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
