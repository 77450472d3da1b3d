"""Large-scale Carbon Containers simulation across regions (the
reference's `examples/simulate_regions.py`; paper Figs 11-16 in
miniature): per-region policy tables, a heterogeneous fleet (mixed
regions, targets and demand scales) through the device fleet simulator,
a multi-region placement demo where the fleet migrates between low- and
high-variability grids, and a placed fleet sweep over 10,080 containers
on the torch backend (``--torch-sweep``, where the reference has
``--jax-sweep``).

    PYTHONPATH=src python -m repro_torch.examples.simulate_regions \
        [--jobs 20] [--backend fleet|scalar] [--fleet 120] [--placement] \
        [--torch-sweep [--containers 10080]] [--device cpu]

``--backend fleet`` runs `FleetSimulatorTorch` on ``--device``;
``scalar`` the host `simulate` per trace. With ``--device cuda`` the
sweep demo also runs the same sweep on the CPU and reports the speedup
and the largest difference of the rows.
"""
import sys
import time

import numpy as np

from repro_torch.carbon.intensity import TraceProvider
from repro_torch.cluster.placement import PlacementConfig, PlacementEngine
from repro_torch.cluster.slices import paper_family
from repro_torch.config import parse_cli
from repro_torch.core.fleet import FleetSimulatorTorch
from repro_torch.core.policy import (CarbonAgnosticPolicy,
                                     CarbonContainerPolicy,
                                     SuspendResumePolicy, VScaleOnlyPolicy)
from repro_torch.core.simulator import SimConfig, simulate
from repro_torch.device import resolve_device
from repro_torch.workload.azure_like import sample_population

DAYS = 5
INTERVAL_S = 300.0


def per_region_tables(n_jobs: int, backend: str, device) -> dict:
    """The per-region policy comparison."""
    fam = paper_family()
    traces = [t.util for t in sample_population(n_jobs, days=DAYS, seed=2)]
    policies = [
        ("carbon-agnostic", CarbonAgnosticPolicy),
        ("suspend/resume", SuspendResumePolicy),
        ("vscale-only", lambda: VScaleOnlyPolicy()),
        ("CC (energy)", lambda: CarbonContainerPolicy("energy")),
        ("CC (performance)", lambda: CarbonContainerPolicy("performance")),
    ]
    target = 45.0
    print(f"{n_jobs} jobs x {DAYS} days, C_target = {target} g/hr "
          f"[backend={backend}]\n")
    out = {}
    for region in ("PL", "NL", "CAISO"):
        carbon = TraceProvider.for_region(region, hours=24 * DAYS, seed=1)
        print(f"--- region {region} ---")
        print(f"  {'policy':18s} {'g/hr':>8s} {'throttle%':>10s} "
              f"{'migs':>6s} {'susp%':>6s}")
        for name, mk in policies:
            if backend == "fleet":
                sim = FleetSimulatorTorch(fam, interval_s=INTERVAL_S)
                res = sim.run(mk(), np.stack(traces, axis=1), carbon, target,
                              state_gb=1.0, device=device)
                rates = res.avg_carbon_rate
                thr = res.avg_throttle_pct
                migs = res.migrations
                susp = res.suspended_frac
            else:
                rates, thr, migs, susp = [], [], [], []
                for tr in traces:
                    r = simulate(mk(), fam, tr, carbon,
                                 SimConfig(target_rate=target, state_gb=1.0))
                    rates.append(r.avg_carbon_rate)
                    thr.append(r.avg_throttle_pct)
                    migs.append(r.migrations)
                    susp.append(r.suspended_frac)
            row = [float(np.mean(rates)), float(np.mean(thr)),
                   float(np.mean(migs)), float(100 * np.mean(susp))]
            out[(region, name)] = row
            print(f"  {name:18s} {row[0]:8.2f} {row[1]:10.2f} "
                  f"{row[2]:6.1f} {row[3]:6.1f}")
        print()
    return out


def heterogeneous_fleet(n: int, device) -> dict:
    """One batched run over a mixed fleet: container i gets a region, a
    carbon target and a demand scale of its own, as stacked carbon traces
    and per-container target vectors."""
    rng = np.random.default_rng(7)
    fam = paper_family()
    regions = ("PL", "NL", "CAISO")
    provs = {r: TraceProvider.for_region(r, hours=24 * DAYS, seed=1)
             for r in regions}
    traces = [t.util for t in sample_population(n, days=DAYS, seed=3)]
    T = len(traces[0])
    tvec = np.arange(T) * INTERVAL_S

    assign = rng.integers(0, len(regions), size=n)
    cmat = np.stack([provs[regions[a]].intensity_series(tvec)
                     for a in assign], axis=1)
    targets = rng.choice([20.0, 35.0, 50.0, 80.0], size=n)
    demand_scale = rng.choice([0.5, 1.0, 2.0, 4.0], size=n)
    state_gb = rng.choice([0.25, 1.0, 4.0], size=n)

    sim = FleetSimulatorTorch(fam, interval_s=INTERVAL_S)
    res = sim.run(CarbonContainerPolicy("energy"), np.stack(traces, axis=1),
                  cmat, targets, state_gb=state_gb,
                  demand_scale=demand_scale, device=device)

    print(f"--- heterogeneous fleet: {n} containers, mixed "
          f"{'/'.join(regions)}, mixed targets/scales ---")
    print(f"  {'group':22s} {'n':>4s} {'g/hr':>8s} {'target':>7s} "
          f"{'throttle%':>10s} {'susp%':>6s}")
    for ri, region in enumerate(regions):
        m = assign == ri
        if not m.any():
            continue
        print(f"  region {region:15s} {int(m.sum()):4d} "
              f"{res.avg_carbon_rate[m].mean():8.2f} "
              f"{targets[m].mean():7.1f} "
              f"{res.avg_throttle_pct[m].mean():10.2f} "
              f"{100 * res.suspended_frac[m].mean():6.1f}")
    for tgt in np.unique(targets):
        m = targets == tgt
        print(f"  target {tgt:5.0f} g/hr     {int(m.sum()):4d} "
              f"{res.avg_carbon_rate[m].mean():8.2f} "
              f"{tgt:7.1f} "
              f"{res.avg_throttle_pct[m].mean():10.2f} "
              f"{100 * res.suspended_frac[m].mean():6.1f}")
    under = (res.avg_carbon_rate <= targets * 1.02).mean()
    kg = res.emissions_g.sum() / 1000.0
    print(f"\n  fleet emissions: {kg:.1f} kg CO2e"
          f" | {100 * under:.0f}% of containers within 2% of target\n")
    return {"emissions_kg": float(kg), "within_target": float(under)}


def multi_region_placement(n: int, device) -> dict:
    """A heterogeneous fleet free to migrate between a dirty low-variability
    grid (PL) and cleaner high-variability ones (NL, CAISO), under
    per-region capacity, against the same fleet frozen on its initial
    regions (the no-migration baseline)."""
    rng = np.random.default_rng(11)
    fam = paper_family()
    regions = ("PL", "NL", "CAISO")
    provs = [TraceProvider.for_region(r, hours=24 * DAYS, seed=1)
             for r in regions]
    traces = [t.util for t in sample_population(n, days=DAYS, seed=5)]
    demand = np.stack(traces, axis=1)
    targets = rng.choice([30.0, 45.0, 80.0], size=n)
    state_gb = rng.choice([0.25, 1.0, 4.0], size=n)

    cap = int(np.ceil(0.6 * n))          # no region may hold the whole fleet
    eng = PlacementEngine(
        fam, provs, interval_s=INTERVAL_S, region_names=regions,
        config=PlacementConfig(capacity=cap, min_dwell=6, hysteresis=0.10))
    res = eng.run(CarbonContainerPolicy("energy"), demand, targets,
                  state_gb=state_gb, compare_static=True, device=device)
    plan, static = res.plan, res.static_fleet

    occ = plan.occupancy()
    print(f"--- multi-region placement: {n} containers over "
          f"{'/'.join(regions)}, capacity {cap}/region ---")
    print(f"  {'region':10s} {'occ@start':>9s} {'occ@end':>8s} "
          f"{'avg g/kWh':>10s}")
    for r, name in enumerate(regions):
        print(f"  {name:10s} {occ[0, r]:9d} {occ[-1, r]:8d} "
              f"{plan.region_intensity[:, r].mean():10.0f}")
    moved_kg = res.total_emissions_g.sum() / 1000.0
    static_kg = static.emissions_g.sum() / 1000.0
    print(f"  placement moves: {int(plan.migrations.sum())} "
          f"(downtime {plan.downtime_s.sum():.0f} s, "
          f"overhead {plan.overhead_g.sum():.1f} g)")
    print(f"  emissions: placed {moved_kg:.1f} kg vs static {static_kg:.1f} "
          f"kg -> {res.saving_vs_static_pct:.1f}% saved")
    eff_m = float(res.carbon_efficiency.mean())
    eff_s = float((static.work_done
                   / np.maximum(static.emissions_g / 1000.0, 1e-12)).mean())
    print(f"  carbon-efficiency (work/kg CO2e): placed {eff_m:.0f} vs "
          f"static {eff_s:.0f} ({100.0 * (eff_m / eff_s - 1.0):+.1f}%)\n")
    return {"moves": int(plan.migrations.sum()),
            "placed_kg": float(moved_kg), "static_kg": float(static_kg),
            "saving_pct": float(res.saving_vs_static_pct)}


def torch_sweep(device, n_containers: int = 10080, n_targets: int = 12,
                days: int = 3) -> dict:
    """A 10k-container placed fleet sweep on the torch backend: the
    planner assigns every trace column a region per epoch, then one
    fleet run per policy sweeps all (target x trace) columns on
    `device`; on the card, against the same sweep on the CPU."""
    from repro_torch.core.spec import SweepSpec
    from repro_torch.workload.azure_like import sample_population_matrix

    n_traces = n_containers // n_targets
    fam = paper_family()
    regions = ("PL", "NL", "CAISO")
    provs = [TraceProvider.for_region(r, hours=24 * days, seed=1)
             for r in regions]
    traces = sample_population_matrix(n_traces, days=days, seed=3)
    T = traces.shape[0]
    cap = int(np.ceil(0.6 * n_traces))
    eng = PlacementEngine(
        fam, provs, interval_s=INTERVAL_S, region_names=regions,
        config=PlacementConfig(capacity=cap, min_dwell=6, hysteresis=0.10))
    targets = list(np.linspace(20.0, 80.0, n_targets))
    policies = {"CC (energy)":
                lambda: CarbonContainerPolicy(variant="energy")}
    cfg = SimConfig(target_rate=0.0)
    n_total = n_traces * n_targets

    def spec(dev):
        return SweepSpec(policies=policies, family=fam, traces=traces,
                         targets=targets, sim=cfg, backend="torch",
                         placement=eng, device=dev)
    print(f"--- torch sweep on {device.type}: {n_total} placed containers "
          f"({n_traces} traces x {n_targets} targets, {T} epochs, "
          f"capacity {cap}/region) ---")
    t0 = time.perf_counter()
    rows = spec(device).run()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = spec(device).run()
    steady = time.perf_counter() - t0
    rate = n_total * T / steady
    out = {"containers": n_total, "epochs": T, "first_s": first,
           "steady_s": steady, "container_epochs_per_s": rate,
           "rows": list(rows)}
    print(f"  {device.type}: first call {first:.2f}s, steady "
          f"{steady:.2f}s  ({rate/1e6:.1f}M container-epochs/s)")
    if device.type == "cuda":
        t0 = time.perf_counter()
        rows_cpu = spec("cpu").run()
        cpu_s = time.perf_counter() - t0
        drift = max(abs(a["carbon_rate_mean"] - b["carbon_rate_mean"])
                    for a, b in zip(rows, rows_cpu))
        out.update(cpu_s=cpu_s, drift=drift, cpu_rows=list(rows_cpu))
        print(f"  cpu:  {cpu_s:.2f}s  -> {cpu_s/steady:.1f}x steady-state "
              f"speedup (parity drift {drift:.1e})")
    print(f"\n  {'target':>7s} {'g/hr':>8s} {'throttle%':>10s} "
          f"{'migs':>6s} {'placement migs':>14s}")
    for r in rows:
        print(f"  {r['target']:7.1f} {r['carbon_rate_mean']:8.2f} "
              f"{r['throttle_mean']:10.2f} {r['migrations_mean']:6.1f} "
              f"{r['placement_migrations_mean']:14.1f}")
    print()
    return out


def main(argv=None) -> dict:
    args = parse_cli(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.get("device", "cuda"))
    n_jobs = int(args.get("jobs", 20))
    backend = args.get("backend", "fleet")
    if backend not in ("fleet", "scalar"):
        raise SystemExit(f"--backend must be 'fleet' or 'scalar', "
                         f"got {backend!r}")
    n_fleet = int(args.get("fleet", 120))
    if "torch-sweep" in args:            # the sweep demo only
        return {"torch_sweep": torch_sweep(
            device, int(args.get("containers", 10080)))}
    if "placement" in args:              # the placement demo only
        return {"placement": multi_region_placement(n_fleet, device)}
    return {"tables": per_region_tables(n_jobs, backend, device),
            "heterogeneous": heterogeneous_fleet(n_fleet, device),
            "placement": multi_region_placement(n_fleet, device)}


if __name__ == "__main__":
    main()
