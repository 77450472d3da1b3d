"""The traffic pipeline: requests -> routing -> autoscaling -> metrics.

Host numpy, copied from `repro.traffic.sim` (the vectorized pipeline).
`simulate_traffic` runs a (T, R) request tensor through the
SLO-constrained router (capacity = each region's fully scaled replica
fleet) and the carbon-capped autoscaler, and returns a `TrafficResult`
with the serving ledger. `demand_mod()` turns the per-region serving
load into the (T, R) demand-modulation matrix the sweep multiplies into
container demand. The sweep's `traffic_*` row metrics come from this
ledger; `sim_torch.traffic_step` is the same step on a device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.traffic.arrivals import UserPopulation
from repro_torch.traffic.autoscale import ReplicaConfig, autoscale
from repro_torch.traffic.routing import (RoutingConfig,
                                         latency_from_timezones, route)


@dataclass(frozen=True)
class TrafficConfig:
    """Everything the traffic layers need, bundled for `sweep_population`."""
    population: UserPopulation = field(default_factory=UserPopulation)
    routing: RoutingConfig = field(default_factory=RoutingConfig)
    replicas: ReplicaConfig = field(default_factory=ReplicaConfig)
    latency_ms: Optional[tuple] = None   # (R, R) rows; default from tz
    demand_gain: float = 1.0             # container-demand coupling gain

    def latency_matrix(self) -> np.ndarray:
        if self.latency_ms is not None:
            lat = np.asarray(self.latency_ms, dtype=np.float64)
            R = self.population.n_regions
            if lat.shape != (R, R):
                raise ValueError(f"latency_ms shape {lat.shape}; "
                                 f"expected ({R}, {R})")
            return lat
        return latency_from_timezones(self.population.tz_offsets())


@dataclass
class TrafficResult:
    """Serving ledger for one traffic run (all per source/serving region)."""
    requests: np.ndarray       # (T, R) offered demand per source region
    routed: np.ndarray         # (T, R) load arriving per serving region
    replicas: np.ndarray       # (T, R) int64 replica counts
    served: np.ndarray         # (T, R) requests served per serving region
    dropped_route: np.ndarray  # (T, R) dropped at routing (no capacity)
    dropped_cap: np.ndarray    # (T, R) dropped at serving (ramp/budget)
    violations: np.ndarray     # (T, R) served outside SLO, per source
    emissions_g: np.ndarray    # (T, R) replica-fleet emissions
    max_capacity: float        # requests/epoch of a fully scaled region
    interval_s: float

    @property
    def offered_total(self) -> float:
        return float(self.requests.sum())

    @property
    def served_total(self) -> float:
        return float(self.served.sum())

    @property
    def dropped_total(self) -> float:
        return float(self.dropped_route.sum() + self.dropped_cap.sum())

    @property
    def violation_total(self) -> float:
        return float(self.violations.sum())

    @property
    def emissions_total_g(self) -> float:
        return float(self.emissions_g.sum())

    @property
    def drop_rate(self) -> float:
        return self.dropped_total / max(self.offered_total, 1e-12)

    @property
    def violation_rate(self) -> float:
        """SLO-violating fraction of offered requests."""
        return self.violation_total / max(self.offered_total, 1e-12)

    @property
    def carbon_per_request_g(self) -> float:
        return self.emissions_total_g / max(self.served_total, 1e-12)

    def demand_mod(self, gain: float = 1.0) -> np.ndarray:
        """(T, R) container-demand multiplier: each region's serving
        load as a fraction of its fully scaled capacity, times `gain`."""
        return gain * self.served / self.max_capacity

    def summary(self) -> dict:
        return {
            "traffic_offered": self.offered_total,
            "traffic_served": self.served_total,
            "traffic_dropped": self.dropped_total,
            "traffic_slo_violations": self.violation_total,
            "traffic_violation_rate": self.violation_rate,
            "traffic_drop_rate": self.drop_rate,
            "traffic_emissions_g": self.emissions_total_g,
            "traffic_carbon_per_request_g": self.carbon_per_request_g,
            "traffic_replica_epochs": float(self.replicas.sum()),
        }


def simulate_traffic(requests, region_intensity, cfg: TrafficConfig,
                     interval_s: float = 300.0) -> TrafficResult:
    """Route + autoscale a (T, R) request tensor against the per-region
    carbon-intensity matrix."""
    requests = np.asarray(requests, dtype=np.float64)
    region_intensity = np.asarray(region_intensity, dtype=np.float64)
    if requests.shape != region_intensity.shape or requests.ndim != 2:
        raise ValueError(f"requests {requests.shape} / region intensity "
                         f"{region_intensity.shape} must both be (T, R)")
    R = requests.shape[1]
    if R != cfg.population.n_regions:
        raise ValueError(f"traffic population spans "
                         f"{cfg.population.n_regions} regions but the "
                         f"request tensor has {R} columns")
    lat = cfg.latency_matrix()
    cap = cfg.replicas.max_capacity(interval_s)
    rt = route(requests, cap, region_intensity, lat, cfg.routing)
    asr = autoscale(rt.routed, region_intensity, cfg.replicas, interval_s)
    return TrafficResult(
        requests=requests, routed=rt.routed, replicas=asr.replicas,
        served=asr.served, dropped_route=rt.dropped, dropped_cap=asr.dropped,
        violations=rt.violations, emissions_g=asr.emissions_g,
        max_capacity=cap, interval_s=float(interval_s))
