"""SLO-constrained carbon-aware request routing (CASPER-style).

Host numpy, copied from `repro.traffic.routing` (the vectorized router).
Each epoch, each source region's request demand is split across serving
regions by greedy water-filling: regions are ranked per source by the
policy key (carbon intensity for ``policy="carbon"``, network latency
for ``policy="latency"``) with SLO-infeasible regions pushed after all
feasible ones, then rank-by-rank each serving region admits its
requesters in source-index order up to remaining capacity. With
``spill=True`` leftovers overflow into SLO-infeasible regions (served,
but counted as SLO violations); otherwise they are dropped. Admission
uses the *cumulative-wants* form

    take_s = min(want_s, max(avail - cum_before_s, 0))

with the exclusive prefix sum taken as a shifted inclusive `cumsum` (a
left fold), as `sim_torch.traffic_step` does on a device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_BIG = 1e9        # rank offset pushing SLO-infeasible regions last


@dataclass(frozen=True)
class RoutingConfig:
    slo_ms: float = 150.0
    policy: str = "carbon"     # "carbon" | "latency"
    spill: bool = True         # serve leftovers out-of-SLO (else drop)


@dataclass
class RouteResult:
    flows: np.ndarray        # (T, S, R) requests routed source -> serving
    routed: np.ndarray       # (T, R) load arriving at each serving region
    dropped: np.ndarray      # (T, S) requests no region could take
    violations: np.ndarray   # (T, S) requests served outside the SLO
    feasible: np.ndarray     # (S, R) SLO-feasibility mask

    @property
    def offered(self) -> float:
        return float(self.flows.sum() + self.dropped.sum())


def latency_from_timezones(tz_offset_h, base_ms: float = 20.0,
                           ms_per_hour: float = 15.0) -> np.ndarray:
    """(R, R) latency matrix from time-zone offsets: base RTT plus a
    term in the circular hour distance (a stand-in for geographic
    distance — regions 12h apart are antipodal)."""
    tz = np.asarray(tz_offset_h, dtype=np.float64)
    d = np.abs(tz[:, None] - tz[None, :]) % 24.0
    d = np.minimum(d, 24.0 - d)
    return base_ms + ms_per_hour * d


def _check_inputs(demand, capacity, carbon, latency):
    demand = np.asarray(demand, dtype=np.float64)
    if demand.ndim == 1:
        demand = demand[None, :]
    T, S = demand.shape
    latency = np.asarray(latency, dtype=np.float64)
    if latency.shape != (S, S):
        raise ValueError(f"latency matrix shape {latency.shape}; "
                         f"expected ({S}, {S})")
    carbon = np.asarray(carbon, dtype=np.float64)
    if carbon.shape != (T, S):
        raise ValueError(f"carbon matrix shape {carbon.shape}; "
                         f"expected ({T}, {S})")
    capacity = np.broadcast_to(
        np.asarray(capacity, dtype=np.float64), (S,)).copy()
    if not np.all(np.isfinite(capacity)) or capacity.min() < 0:
        raise ValueError("capacity must be finite and non-negative")
    return demand, capacity, carbon, latency, T, S


def _score(carbon_row, latency, feas, policy):
    """(S, R) preference score: policy key + big infeasibility offset."""
    if policy == "carbon":
        key = np.broadcast_to(carbon_row[None, :], latency.shape)
    elif policy == "latency":
        key = latency
    else:
        raise ValueError(f"unknown routing policy {policy!r}")
    return key + np.where(feas, 0.0, _BIG)


def route(demand, capacity, carbon, latency,
          cfg: RoutingConfig = RoutingConfig()) -> RouteResult:
    """Vectorized router over all T epochs at once."""
    demand, capacity, carbon, latency, T, S = _check_inputs(
        demand, capacity, carbon, latency)
    feas = latency <= cfg.slo_ms                        # (S, R)
    n_feas = feas.sum(axis=1)                           # (S,)

    flows = np.zeros((T, S, S))
    remaining = demand.copy()                           # (T, S)
    avail = np.broadcast_to(capacity[None, :], (T, S)).copy()
    avail0 = avail.copy()

    # per-source preference ranks (carbon keys vary over T, so the
    # argsort is per epoch; latency keys are epoch-invariant)
    offs = np.where(feas, 0.0, _BIG)                    # (S, R)
    if cfg.policy == "carbon":
        score = carbon[:, None, :] + offs[None, :, :]
    else:
        score = np.broadcast_to((latency + offs)[None, :, :],
                                (T, S, S)).copy()
    pref = np.argsort(score, axis=2, kind="stable")     # (T, S, R)

    for k in range(S):
        choice = pref[:, :, k]                          # (T, S)
        requesting = (np.ones((T, S), dtype=bool) if cfg.spill
                      else (k < n_feas)[None, :] & np.ones((T, 1), dtype=bool))
        for r in range(S):
            m = (choice == r) & requesting
            want = np.where(m, remaining, 0.0)          # (T, S)
            cum = np.cumsum(want, axis=1)
            cum_before = np.concatenate(
                [np.zeros((T, 1)), cum[:, :-1]], axis=1)
            take = np.minimum(want,
                              np.maximum(avail[:, r:r + 1] - cum_before, 0.0))
            flows[:, :, r] += take
            remaining = remaining - take
            avail[:, r] = np.maximum(avail[:, r] - cum[:, -1], 0.0)
    routed = avail0 - avail                             # (T, R)
    violations = (flows * (~feas)[None, :, :]).sum(axis=2)
    return RouteResult(flows=flows, routed=routed, dropped=remaining,
                       violations=violations, feasible=feas)

