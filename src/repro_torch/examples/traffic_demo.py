"""Carbon-aware traffic demo (the reference's `examples/traffic_demo.py`).

A population of users spread over three regions eight time-zone-hours
apart offers a diurnal, bursty request stream. Requests are routed per
epoch by carbon intensity under an SLO latency bound (against a
latency-only baseline), per-region replica fleets autoscale to the
routed load (host numpy, `traffic.simulate_traffic`), and the serving
load modulates container demand through the placed fleet sweep on the
port's torch backend, on ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.traffic_demo
        [--users 1000000] [--days 1] [--budget <g/epoch>]
        [--sweep-traces 24] [--device cpu]
"""
import sys

import numpy as np

from repro_torch.carbon.intensity import TraceProvider
from repro_torch.cluster.placement import PlacementConfig, PlacementEngine
from repro_torch.cluster.slices import paper_family
from repro_torch.config import parse_cli
from repro_torch.core.policy import CarbonContainerPolicy
from repro_torch.core.simulator import SimConfig
from repro_torch.core.spec import SweepSpec
from repro_torch.device import resolve_device
from repro_torch.traffic import (RoutingConfig, TrafficConfig, UserPopulation,
                                 request_matrix, simulate_traffic)
from repro_torch.traffic.autoscale import ReplicaConfig
from repro_torch.workload.azure_like import sample_population

INTERVAL_S = 300.0
REGIONS = ("PL", "NL", "CAISO")


def main(argv=None) -> dict:
    args = parse_cli(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.get("device", "cuda"))
    n_users = int(args.get("users", 1_000_000))
    days = int(args.get("days", 1))
    budget = float(args["budget"]) if "budget" in args else None
    n_sweep = int(args.get("sweep-traces", 24))
    T = int(days * 86400 / INTERVAL_S)

    provs = [TraceProvider.for_region(r, hours=24 * days, seed=1)
             for r in REGIONS]
    intensity = np.stack(
        [p.intensity_series(np.arange(T) * INTERVAL_S) for p in provs],
        axis=1)
    pop = UserPopulation(n_users=n_users, n_regions=3,
                         tz_offset_h=(0.0, 8.0, 16.0), seed=3)
    reps = ReplicaConfig(max_replicas=8, max_step=4,
                         budget_g_per_epoch=budget)
    arr = request_matrix(pop, T, INTERVAL_S)
    print(f"population: {n_users:,} users, {arr.offered_total:,.0f} "
          f"requests over {days} day(s), regions {REGIONS}")

    print(f"\n{'routing':>10} {'served':>14} {'dropped':>12} "
          f"{'SLO viol':>10} {'g CO2/1k req':>13}")
    results = {}
    for pol in ("carbon", "latency"):
        cfg = TrafficConfig(population=pop, replicas=reps,
                            routing=RoutingConfig(slo_ms=200.0, policy=pol))
        res = simulate_traffic(arr.requests, intensity, cfg, INTERVAL_S)
        results[pol] = res
        print(f"{pol:>10} {res.served_total:>14,.0f} "
              f"{res.dropped_total:>12,.0f} {res.violation_total:>10,.0f} "
              f"{1000.0 * res.carbon_per_request_g:>13.3f}")
    rc, rl = results["carbon"], results["latency"]
    saved = 1.0 - rc.carbon_per_request_g / rl.carbon_per_request_g
    print(f"\ncarbon routing emits {100.0 * saved:.1f}% less per request "
          f"than latency routing at the same SLO-violation rate")

    # the same traffic driving the placed fleet sweep end to end
    fam = paper_family()
    traces = [t.util for t in sample_population(n_sweep, days=days, seed=5)]
    eng = PlacementEngine(fam, provs, region_names=REGIONS,
                          config=PlacementConfig(capacity=n_sweep,
                                                 min_dwell=6))
    tc = TrafficConfig(population=pop, replicas=reps,
                       routing=RoutingConfig(slo_ms=200.0))
    rows = SweepSpec(
        policies={"carbon_containers":
                  lambda: CarbonContainerPolicy("energy")},
        family=fam, traces=traces, targets=[30.0, 60.0],
        sim=SimConfig(target_rate=0.0), backend="torch", placement=eng,
        traffic=tc, device=device).run()
    print("\nplaced fleet sweep with traffic-modulated demand:")
    for r in rows:
        print(f"  target {r['target']:>5.1f}: carbon rate "
              f"{r['carbon_rate_mean']:.2f} g/h, throttle "
              f"{r['throttle_mean']:.2f}%, carbon/request "
              f"{1000.0 * r['traffic_carbon_per_request_g']:.3f} g/1k")
    return {"offered_total": float(arr.offered_total),
            "routing": {pol: {"served": float(r.served_total),
                              "dropped": float(r.dropped_total),
                              "violations": float(r.violation_total),
                              "carbon_per_request_g":
                                  float(r.carbon_per_request_g)}
                        for pol, r in results.items()},
            "carbon_saving": saved, "sweep_rows": list(rows)}


if __name__ == "__main__":
    main()
