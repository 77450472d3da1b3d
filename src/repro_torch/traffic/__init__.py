"""Carbon-aware traffic subsystem: demand -> routing -> provisioning.

Host numpy copies of `repro.traffic` (`arrivals`, `routing`,
`autoscale`, `sim`), and `sim_torch`: the per-epoch routing +
autoscaling step on a device, folded into the fleet scan of
`repro_torch.core.fleet` (all (R,)/(R, R) carries).
"""
from repro_torch.traffic.arrivals import (ArrivalTensor, UserPopulation,
                                          request_matrix)
from repro_torch.traffic.autoscale import (AutoscaleResult, ReplicaConfig,
                                           autoscale)
from repro_torch.traffic.routing import (RouteResult, RoutingConfig,
                                         latency_from_timezones, route)
from repro_torch.traffic.sim import (TrafficConfig, TrafficResult,
                                     simulate_traffic)

__all__ = [
    "ArrivalTensor", "UserPopulation", "request_matrix",
    "RouteResult", "RoutingConfig", "latency_from_timezones", "route",
    "AutoscaleResult", "ReplicaConfig", "autoscale",
    "TrafficConfig", "TrafficResult", "simulate_traffic",
]
