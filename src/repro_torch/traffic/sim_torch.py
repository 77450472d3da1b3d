"""The traffic step on a device: routing + autoscaling for one epoch.

`traffic_step` is the per-epoch routing + autoscaling update of
`repro_torch.traffic.sim` (`routing.route`, `autoscale.autoscale`) on
(R,)-shaped float64 tensors with a hashable `TrafficSpec`. The fleet
scan (`repro_torch.core.fleet._fleet_scan`) folds it into its epoch
step with an (R,) replica-count carry; each epoch's demand modulation
is then a gather over the epoch's (R,) mod row.

Replica counts must be exact. The preference and efficiency orders use
a stable sort, as the host pipeline does; quotients by constants are
`devmath.divide`, the water-filling's prefix sums are `ordered_cumsum`
(NumPy's own left fold for up to 1,024 entries), and the carbon budget's
cut is `budget_admits` (NumPy's decision at any length): the same bits
on the card and on the CPU.

`simulate_traffic_torch` runs the step over T epochs and returns the
host `TrafficResult`, like `simulate_traffic`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.devmath import budget_admits, divide, ordered_cumsum
from repro_torch.traffic.sim import TrafficConfig, TrafficResult

_BIG = 1e9        # rank offset pushing SLO-infeasible regions last


class TrafficSpec(NamedTuple):
    """Hashable constants of `traffic_step`."""
    feas: tuple            # R rows of R bools (SLO feasibility)
    n_feas: tuple          # feasible-region count per source
    lat: tuple             # R rows of R floats
    policy: str
    spill: bool
    thru: float
    base_w: float
    peak_w: float
    kmax: int
    min_rep: int
    max_step: int
    budget: Optional[float]
    gain: float
    dt: float
    R: int

    @classmethod
    def from_config(cls, cfg: TrafficConfig,
                    interval_s: float) -> "TrafficSpec":
        lat = cfg.latency_matrix()
        feas = lat <= cfg.routing.slo_ms
        rc = cfg.replicas
        return cls(
            feas=tuple(tuple(bool(x) for x in row) for row in feas),
            n_feas=tuple(int(x) for x in feas.sum(axis=1)),
            lat=tuple(tuple(float(x) for x in row) for row in lat),
            policy=cfg.routing.policy, spill=bool(cfg.routing.spill),
            thru=float(rc.throughput_rps), base_w=float(rc.base_w),
            peak_w=float(rc.peak_w), kmax=int(rc.max_replicas),
            min_rep=int(rc.min_replicas), max_step=int(rc.max_step),
            budget=(None if rc.budget_g_per_epoch is None
                    else float(rc.budget_g_per_epoch)),
            gain=float(cfg.demand_gain), dt=float(interval_s),
            R=int(cfg.population.n_regions))

    @property
    def cap1(self) -> float:
        return self.thru * self.dt

    @property
    def max_capacity(self) -> float:
        return self.kmax * self.cap1


class _Consts(NamedTuple):
    offs: torch.Tensor          # (R, R) infeasibility offsets
    lat_score: torch.Tensor     # (R, R) latency + offsets
    infeas: torch.Tensor        # (R, R) f64: 1 where (source, r) is out of SLO
    requesting: torch.Tensor    # (R, R) bool: [k, s] source s asks at rank k
    k_idx: torch.Tensor         # (1, K) levels 1..K


@lru_cache(maxsize=16)
def _consts(spec: TrafficSpec, device: torch.device) -> _Consts:
    R = spec.R
    feas = np.asarray(spec.feas, dtype=bool)
    offs = np.where(feas, 0.0, _BIG)
    if spec.spill:
        requesting = np.ones((R, R), dtype=bool)
    else:
        requesting = np.array([[k < spec.n_feas[s] for s in range(R)]
                               for k in range(R)])
    f64 = dict(dtype=torch.float64, device=device)
    return _Consts(
        offs=torch.as_tensor(offs, **f64),
        lat_score=torch.as_tensor(np.asarray(spec.lat) + offs, **f64),
        infeas=torch.as_tensor((~feas).astype(np.float64), **f64),
        requesting=torch.as_tensor(requesting, device=device),
        k_idx=torch.arange(1, spec.kmax + 1, **f64)[None, :])


def traffic_step(spec: TrafficSpec, rep0, req_row, c_row):
    """One epoch: route `req_row` by the carbon row, autoscale replicas.

    Returns ``(rep1, (mod, routed, served, drop_route, drop_cap, viol,
    emis))``, all (R,) float64; `rep1` is the replica-count carry.
    """
    R = spec.R
    k = _consts(spec, c_row.device)
    cap1 = spec.cap1
    cap = spec.max_capacity

    # ---- routing: greedy water-filling in preference-rank rounds ----
    score = c_row[None, :] + k.offs if spec.policy == "carbon" \
        else k.lat_score
    pref = torch.sort(score, dim=1, stable=True).indices
    remaining = req_row
    avail = torch.full((R,), cap, dtype=torch.float64, device=c_row.device)
    viol = torch.zeros_like(avail)
    for rank in range(R):
        choice = pref[:, rank]
        for r in range(R):
            want = torch.where((choice == r) & k.requesting[rank],
                               remaining, 0.0)
            cum = ordered_cumsum(want)
            cum_before = torch.cat((torch.zeros_like(cum[:1]), cum[:-1]))
            take = torch.minimum(
                want, torch.clamp(avail[r] - cum_before, min=0.0))
            # infeasible (source, r) pairs are static: spilled service
            viol = viol + take * k.infeas[:, r]
            remaining = remaining - take
            avail[r] = torch.clamp(avail[r] - cum[-1], min=0.0)
    routed = cap - avail
    drop_route = remaining

    # ---- autoscaling: CarbonScaler greedy over the (R, K) table ----
    need = torch.ceil(divide(routed, cap1))
    lo = torch.clamp(rep0 - spec.max_step, min=float(spec.min_rep))
    hi = torch.clamp(rep0 + spec.max_step, max=float(spec.kmax))
    desired = torch.minimum(torch.maximum(need, lo), hi)
    span = spec.peak_w - spec.base_w
    if spec.budget is None:
        n = desired
    else:
        n = lo + greedy_counts(routed, c_row, lo, desired, k.k_idx, cap1,
                               spec.base_w, span, spec.dt, spec.budget)
    served = torch.minimum(routed, n * cap1)
    drop_cap = routed - served
    pw = n * spec.base_w + span * divide(served, cap1)
    emis = divide(divide(pw * spec.dt, 3600.0) * c_row, 1000.0)
    mod = divide(spec.gain * served, cap)
    return n, (mod, routed, served, drop_route, drop_cap, viol, emis)


def greedy_counts(want, chat, lo, desired, k_idx, capw, base_w, span, dt,
                  budget):
    """Levels admitted per row by the CarbonScaler greedy over the
    (rows, K) marginal table: mandatory levels first, then optional
    levels by descending work per gram (a stable sort; zero-gram levels
    first) while the running grams fit `budget`. Shared by the
    autoscaler here and `repro_torch.core.elasticity_torch`. Returns
    int64 counts."""
    w = torch.clip(want[:, None] - (k_idx - 1.0) * capw, 0.0, capw)
    g = divide(divide((base_w + span * divide(w, capw)) * dt, 3600.0)
               * chat[:, None], 1000.0)
    mand = k_idx <= lo[:, None]
    opt = (k_idx > lo[:, None]) & (k_idx <= desired[:, None])
    free = g <= 0.0
    eff = w / torch.where(free, 1.0, g)
    score = torch.where(opt, torch.where(free, -torch.inf, -eff),
                        torch.inf).reshape(-1)
    order = torch.sort(score, stable=True).indices
    gs = torch.where(opt, g, 0.0).reshape(-1)[order]
    admit = budget_admits(torch.where(mand, g, 0.0).reshape(-1), gs, budget,
                          opt.reshape(-1)[order])
    admitted = torch.empty_like(admit)
    admitted[order] = admit
    return admitted.view(g.shape).sum(dim=1)


def simulate_traffic_torch(requests, region_intensity, cfg: TrafficConfig,
                           interval_s: float = 300.0,
                           device="cuda") -> TrafficResult:
    """`traffic_step` over T epochs on `device` (float64)."""
    dev = resolve_device(device)
    requests = np.asarray(requests, dtype=np.float64)
    region_intensity = np.asarray(region_intensity, dtype=np.float64)
    spec = TrafficSpec.from_config(cfg, interval_s)
    R = spec.R
    if requests.shape != region_intensity.shape or requests.ndim != 2 \
            or requests.shape[1] != R:
        raise ValueError(f"requests {requests.shape} / intensity "
                         f"{region_intensity.shape} must be (T, {R})")
    T = requests.shape[0]
    req = torch.as_tensor(requests, device=dev)
    cmat = torch.as_tensor(region_intensity, device=dev)
    rep = torch.full((R,), float(spec.min_rep), dtype=torch.float64,
                     device=dev)
    outs = torch.empty((7, T, R), dtype=torch.float64, device=dev)
    for t in range(T):
        rep, step = traffic_step(spec, rep, req[t], cmat[t])
        for j, v in enumerate(step[1:]):
            outs[j, t] = v
        outs[6, t] = rep
    routed, served, drop_route, drop_cap, viol, emis, reps = \
        outs.cpu().numpy()
    return TrafficResult(
        requests=requests, routed=routed,
        replicas=np.rint(reps).astype(np.int64),
        served=served, dropped_route=drop_route, dropped_cap=drop_cap,
        violations=viol, emissions_g=emis,
        max_capacity=spec.max_capacity, interval_s=float(interval_s))
