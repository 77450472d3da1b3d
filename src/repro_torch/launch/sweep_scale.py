"""The reference's full-scale placed sweep, `benchmarks/figs.py::
jax_sweep_scale`, as the port runs it:

    cap, eng = engine(n_traces)
    rows = spec(demand, eng, "cpu").run()      # or device="cuda"

over a (T, n_traces) `demand`: n_traces Azure-like traces x 10 targets
(20…80 g/h), one day of 5-minute epochs, regions PL/NL/CAISO each capped
at 0.6 · n_traces, `min_dwell=6`, `hysteresis=0.10`,
`CarbonContainerPolicy("energy")`, with the reference's four layers and
fault plan: a 1,000,000-user traffic population (replicas: 8 at most, 4
a step), the virtual energy supply with a regional outage and a
fleet-wide carbon shock, per-container elasticity (4 levels of 0.3)
under a shaped budget of 2.5 g per trace per epoch, and carbon-feed
dropouts and a blackout through the degrade ladder, meter gaps and
migration failures. At jax_sweep_scale's 100,000 traces the fleet is
1,000,000 containers; nothing is cut. `elasticity=False` leaves the
elasticity layer out, so that traffic and energy fold into the fleet
scan; `layered=False` runs the plain placed sweep.
"""
from __future__ import annotations

import numpy as np

REGIONS = ("PL", "NL", "CAISO")
N_TARGETS = 10


def engine(n_traces: int):
    """(capacity, PlacementEngine) of the sweep: one day."""
    from repro_torch.carbon.intensity import TraceProvider
    from repro_torch.cluster.placement import PlacementConfig, PlacementEngine
    from repro_torch.cluster.slices import paper_family
    provs = [TraceProvider.for_region(r, hours=24, seed=1) for r in REGIONS]
    cap = int(np.ceil(0.6 * n_traces))
    return cap, PlacementEngine(
        paper_family(), provs, region_names=REGIONS,
        config=PlacementConfig(capacity=cap, min_dwell=6, hysteresis=0.10))


def layers(n_traces: int, elasticity: bool = True) -> dict:
    """The sweep's traffic, energy, elasticity and fault settings for one
    day, as `benchmarks/figs.py::jax_sweep_scale` derives them from
    n_traces."""
    from repro_torch.core.elasticity import ElasticityConfig
    from repro_torch.energy import EnergyConfig, GridEventConfig
    from repro_torch.robustness import (CarbonFeedFaults, DegradeConfig,
                                        FaultPlan, MigrationFaults,
                                        PowerTelemetryFaults)
    from repro_torch.traffic import TrafficConfig, UserPopulation
    from repro_torch.traffic.autoscale import ReplicaConfig
    T = 288
    out = dict(
        traffic=TrafficConfig(
            population=UserPopulation(n_users=1_000_000, n_regions=3, seed=3),
            replicas=ReplicaConfig(max_replicas=8, max_step=4)),
        energy=EnergyConfig(events=GridEventConfig(
            outages=((1, T // 3, T // 24),),
            shocks=((-1, T // 2, T // 12, 1.6),))),
        faults=FaultPlan(
            carbon=CarbonFeedFaults(dropout_prob=0.2,
                                    blackouts=((-1, T // 3, T // 12),)),
            power=PowerTelemetryFaults(gap_prob=0.05),
            migration=MigrationFaults(fail_prob=0.2, backoff_cap=8),
            degrade=DegradeConfig(mode="ladder", ttl_epochs=3),
            seed=11))
    if elasticity:
        out["elasticity"] = ElasticityConfig(
            k_levels=4, unit_capacity=0.3, budget_g_per_epoch=2.5 * n_traces,
            forecast="forecast", shape_budget=True)
    return out


def spec(demand, eng, device, layered: bool = True, elasticity: bool = True):
    """The `SweepSpec` of the sweep over `demand` (T, n_traces)."""
    from repro_torch.cluster.slices import paper_family
    from repro_torch.core.policy import CarbonContainerPolicy
    from repro_torch.core.spec import SweepSpec
    extra = layers(demand.shape[1], elasticity) if layered else {}
    return SweepSpec(
        policies={"carbon_containers":
                  lambda: CarbonContainerPolicy(variant="energy")},
        family=paper_family(), traces=demand,
        targets=list(np.linspace(20.0, 80.0, N_TARGETS)),
        placement=eng, device=device, **extra)
