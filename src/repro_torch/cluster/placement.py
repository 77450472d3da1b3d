"""Multi-region placement planner on a device.

Each monitoring epoch the planner assigns every container of an (N,)
fleet to one of R regions (stacked carbon traces), weighing the
projected carbon saving over an amortization horizon against the
stop-and-copy cost, with hysteresis, a minimum dwell and per-region
capacity. The decision model and the host prologue are the reference's
(`repro.cluster.placement`, whose module docstring derives them):

    p_est   = base_b + (peak_b - base_b) * min(d / mult_b, 1)   [W]
    save(r) = p_est * (c[a] - c[r]) / 1000 * H_hr               [g, horizon]
    cost(r) = 2*base_b * mig_s / 3600 * 0.5*(c[a]+c[r]) / 1000  [g, one move]
    net(r)  = save(r) - (1 + hysteresis) * cost(r)

`plan_torch` ports `repro.cluster.placement_jax._plan_scan`: a Python
loop over epochs of device-side tensor ops, float64 throughout, with no
host sync inside the loop. With a fault plan the loop also carries the
retry state of failed migrations (see `plan_torch`). Capacity admission
runs a fixed R preference rounds per epoch in one call of
`placement_kernel.admission_rounds` (one launch of the CUDA kernel on
the card). The reference ends its round
loop early when a round wants or denies nothing; the rounds after such a
round are no-ops, so a fixed count gives the same plan without reading
a flag back to the host each round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.migration import MigrationCostModel
from repro_torch.cluster.placement_kernel import _prefer, admission_rounds
from repro_torch.cluster.slices import SliceFamily
from repro_torch.device import resolve_device
from repro_torch.devmath import divide


@dataclass(frozen=True)
class PlacementConfig:
    """Knobs of the migrate/stay decision (see module docstring)."""
    horizon_intervals: int = 12      # amortize one move over H epochs
    hysteresis: float = 0.10         # saving must beat (1+h) * cost
    min_dwell: int = 6               # epochs pinned after a placement move
    link_gbps: float = 0.25          # cross-region (WAN) state bandwidth
    capacity: Optional[object] = None  # per-region container cap: int | (R,)

    def capacity_vector(self, n_regions: int) -> Optional[np.ndarray]:
        if self.capacity is None:
            return None
        raw = np.broadcast_to(np.asarray(self.capacity), (n_regions,))
        cap = raw.astype(np.int64)
        if (cap != np.asarray(raw, dtype=np.float64)).any():
            raise ValueError(f"per-region capacity must be integral, got "
                             f"{raw!r}")
        if (cap < 1).any():
            raise ValueError("per-region capacity must be >= 1")
        return cap.copy()


@dataclass
class PlacementPlan:
    """Epoch-by-epoch region assignment for an (N,) fleet.

    `assign[n, i]` is container i's region during epoch n (a move
    decided at epoch n serves epoch n from the destination).
    """
    assign: np.ndarray               # (T, N) int64 region index
    migrations: np.ndarray           # (N,) placement moves per container
    overhead_g: np.ndarray           # (N,) stop-and-copy emissions (g)
    downtime_s: np.ndarray           # (N,) stop-and-copy downtime (s)
    region_intensity: np.ndarray     # (T, R) g/kWh per region per epoch
    region_names: tuple
    initial: np.ndarray              # (N,) pre-epoch-0 region index
    failed_migrations: Optional[np.ndarray] = None   # (N,) failed attempts

    @property
    def n_regions(self) -> int:
        return self.region_intensity.shape[1]

    def carbon_matrix(self) -> np.ndarray:
        """(T, N) per-container intensity under the planned assignment."""
        T = self.assign.shape[0]
        return self.region_intensity[np.arange(T)[:, None], self.assign]

    def occupancy(self) -> np.ndarray:
        """(T, R) containers per region per epoch."""
        T, _ = self.assign.shape
        out = np.zeros((T, self.n_regions), dtype=np.int64)
        for r in range(self.n_regions):
            out[:, r] = (self.assign == r).sum(axis=1)
        return out


@dataclass
class PlacementResult:
    """A placed fleet run: the fleet's `FleetResult` plus the plan that
    drove it. Total emissions add the placement stop-and-copy overhead."""
    plan: PlacementPlan
    fleet: object                    # repro_torch.core.fleet.FleetResult
    static_fleet: object = None      # optional no-migration baseline

    @property
    def total_emissions_g(self) -> np.ndarray:
        return self.fleet.emissions_g + self.plan.overhead_g

    @property
    def carbon_efficiency(self) -> np.ndarray:
        """Work done per kg CO2e, overhead included (paper's merit figure)."""
        kg = np.maximum(self.total_emissions_g / 1000.0, 1e-12)
        return self.fleet.work_done / kg

    @property
    def saving_vs_static_pct(self) -> float:
        """Fleet-total emissions saving vs the no-migration baseline."""
        if self.static_fleet is None:
            raise ValueError("run with compare_static=True to populate "
                             "the static baseline")
        stat = float(self.static_fleet.emissions_g.sum())
        moved = float(self.total_emissions_g.sum())
        return 100.0 * (stat - moved) / max(stat, 1e-12)


class PlacementEngine:
    """Assign an (N,) fleet across R regions, one decision per epoch.

    `regions` is either a (T, R) intensity matrix or a sequence of
    providers exposing `intensity_series` (see repro_torch.carbon).
    Plan with `plan_torch(engine, demand, device=...)`; `run` plans and
    then advances the fleet on the planned regions.
    """

    def __init__(self, family: SliceFamily, regions,
                 interval_s: float = 300.0,
                 migration: Optional[MigrationCostModel] = None,
                 config: Optional[PlacementConfig] = None,
                 region_names: Optional[Sequence[str]] = None):
        self.tables = family.tables()
        self.regions = regions
        self.interval_s = float(interval_s)
        self.mig = migration or MigrationCostModel()
        self.config = config or PlacementConfig()
        if isinstance(regions, np.ndarray):
            n_regions = regions.shape[1]
        else:
            n_regions = len(regions)
        if n_regions < 1:
            raise ValueError("need at least one region")
        if region_names is None:
            region_names = tuple(f"r{i}" for i in range(n_regions))
        if len(region_names) != n_regions:
            raise ValueError("region_names length does not match regions")
        self.region_names = tuple(region_names)
        self.n_regions = n_regions

    def _region_matrix(self, T: int) -> np.ndarray:
        """(T, R) intensity at each epoch start."""
        if isinstance(self.regions, np.ndarray):
            m = np.asarray(self.regions, dtype=np.float64)
            if m.ndim != 2 or m.shape[1] != self.n_regions:
                raise ValueError(f"region matrix shape {m.shape}; expected "
                                 f"(T, {self.n_regions})")
            if m.shape[0] < T:
                raise ValueError(f"region matrix covers {m.shape[0]} epochs; "
                                 f"demand needs {T}")
            return m[:T]
        t = np.arange(T, dtype=np.float64) * self.interval_s
        return np.stack([p.intensity_series(t) for p in self.regions],
                        axis=1)

    def _initial_assignment(self, N: int, initial,
                            cap: Optional[np.ndarray]) -> np.ndarray:
        R = self.n_regions
        if cap is not None and int(cap.sum()) < N:
            raise ValueError(f"total capacity {int(cap.sum())} < fleet "
                             f"size {N}")
        if initial is None:
            if cap is None:
                assign = np.arange(N, dtype=np.int64) % R  # round-robin
            else:
                # capacity-aware round-robin: cycle regions, skipping
                # full ones, so uneven capacity vectors stay feasible
                rep_r = np.repeat(np.arange(R, dtype=np.int64), cap)
                rep_k = np.concatenate([np.arange(c) for c in cap])
                assign = rep_r[np.lexsort((rep_r, rep_k))][:N]
        else:
            assign = np.asarray(initial, dtype=np.int64).copy()
            if assign.shape != (N,):
                raise ValueError(f"initial assignment shape {assign.shape}; "
                                 f"expected ({N},)")
            if assign.size and (assign.min() < 0 or assign.max() >= R):
                raise ValueError("initial assignment region out of range")
        if cap is not None:
            occ = np.bincount(assign, minlength=R)
            if (occ > cap).any():
                raise ValueError("initial assignment exceeds region capacity")
        return assign

    def _prep(self, demand, state_gb, initial):
        demand = np.asarray(demand, dtype=np.float64)
        if demand.ndim == 1:
            demand = demand[:, None]
        if demand.ndim != 2:
            raise ValueError("demand must be (T,) or (T, N)")
        if demand.size and demand.min() < 0.0:
            raise ValueError("placement demand must be non-negative")
        T, N = demand.shape
        cmat = self._region_matrix(T)
        cap = self.config.capacity_vector(self.n_regions)
        assign = self._initial_assignment(N, initial, cap)
        state_gb = np.broadcast_to(
            np.asarray(state_gb, dtype=np.float64), (N,))
        # per-container stop-and-copy time & idle-power gram coefficient,
        # hoisted: state size and link bandwidth are epoch-invariant
        mig_s = self.mig.stop_and_copy_time_batch(
            state_gb, np.broadcast_to(self.config.link_gbps, (N,)))
        base_b = float(self.tables.base_w[self.tables.baseline_idx])
        cost0 = 2.0 * base_b * mig_s / 3600.0
        return demand, cmat, cap, assign, mig_s, cost0

    def run(self, policy, demand, targets, epsilon: float = 0.05,
            state_gb=1.0, demand_scale=1.0, initial=None,
            record: bool = False, plan: Optional[PlacementPlan] = None,
            compare_static: bool = False, device="cuda") -> PlacementResult:
        """Plan placement with `plan_torch`, then advance the fleet on the
        planned regions with `FleetSimulatorTorch`, both on `device`.

        `plan` reuses a precomputed `PlacementPlan` (from this engine, on
        the same scaled demand) instead of re-planning. With
        `compare_static=True` the same fleet also runs frozen on the
        plan's own initial assignment (the no-migration baseline),
        populating `PlacementResult.saving_vs_static_pct`.
        """
        from repro_torch.core.fleet import FleetSimulatorTorch
        demand = np.asarray(demand, dtype=np.float64)
        if demand.ndim == 1:
            demand = demand[:, None]
        scaled = demand
        if demand_scale is not None and np.any(
                np.asarray(demand_scale) != 1.0):
            scaled = demand * demand_scale
        if plan is None:
            plan = plan_torch(self, scaled, state_gb=state_gb,
                              initial=initial, device=device)
        elif plan.assign.shape != scaled.shape:
            raise ValueError(f"plan covers {plan.assign.shape}, demand is "
                             f"{scaled.shape}")
        sim = FleetSimulatorTorch(self.tables, interval_s=self.interval_s,
                                  migration=self.mig)
        kw = dict(epsilon=epsilon, state_gb=state_gb, record=record,
                  device=device)
        # the plan's indexed carbon: the (T, R) table and (T, N) codes
        fleet = sim.run(policy, scaled, (plan.region_intensity,
                                         plan.assign), targets, **kw)
        static_fleet = None
        if compare_static:
            frozen = np.repeat(plan.initial[None, :], len(plan.assign), 0)
            static_fleet = sim.run(policy, scaled, (plan.region_intensity,
                                                    frozen), targets, **kw)
        return PlacementResult(plan=plan, fleet=fleet,
                               static_fleet=static_fleet)


def _trivial_plan(engine, cmat, assign0, has_faults=False) -> PlacementPlan:
    """Plan for shapes where no move is ever possible (N=0, R=1, T=0)."""
    T = cmat.shape[0]
    N = assign0.shape[0]
    return PlacementPlan(
        assign=np.broadcast_to(assign0, (T, N)).copy(),
        migrations=np.zeros(N, dtype=np.int64),
        overhead_g=np.zeros(N, dtype=np.float64),
        downtime_s=np.zeros(N, dtype=np.float64),
        region_intensity=cmat,
        region_names=engine.region_names,
        initial=assign0.copy(),
        failed_migrations=np.zeros(N, dtype=np.int64) if has_faults
        else None)


def plan_torch(engine: PlacementEngine, demand, state_gb=1.0, initial=None,
               faults=None, device="cuda") -> PlacementPlan:
    """Plan the (T, N) region assignment on `device`; the same
    `PlacementPlan` as the reference's `plan_jax` for the same inputs.

    `faults` (a `repro_torch.robustness.FaultPlan`) injects the seeded
    migration-failure mask: a failed attempt pays the stop-and-copy cost
    (overhead grams and downtime) but the container stays put, and after
    its k-th consecutive failure waits ``min(backoff_base * 2**(k-1),
    backoff_cap)`` epochs before it is eligible again. A move resets the
    streak. Failed attempts land in `PlacementPlan.failed_migrations`.
    """
    from repro_torch.robustness.faults import migration_failure_mask
    dev = resolve_device(device)
    demand, cmat, cap, assign0, mig_s, cost0 = engine._prep(
        demand, state_gb, initial)
    T, N = demand.shape
    R = engine.n_regions
    fail_mat = migration_failure_mask(faults, T, N)
    has_faults = fail_mat is not None
    if N == 0 or R == 1 or T == 0:
        # nothing can ever move: no containers, no other region, or no epoch
        return _trivial_plan(engine, cmat, assign0, has_faults)
    t = engine.tables
    b = t.baseline_idx
    base_b = float(t.base_w[b])
    span_b = float(t.peak_w[b]) - base_b
    mult_b = float(t.multiple[b])
    cfg = engine.config
    h_hr = cfg.horizon_intervals * engine.interval_s / 3600.0
    hk = 1.0 + cfg.hysteresis
    min_dwell = int(cfg.min_dwell)

    f64 = dict(dtype=torch.float64, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    dem = torch.as_tensor(demand, **f64)
    cm = torch.as_tensor(cmat, **f64)
    cost0_t = torch.as_tensor(cost0, **f64)
    mig_s_t = torch.as_tensor(mig_s, **f64)
    assign = torch.as_tensor(assign0, **i32)
    dwell = torch.full((N,), 10 ** 6, **i32)            # first move is free
    migrations = torch.zeros(N, **i32)
    overhead_g = torch.zeros(N, **f64)
    downtime_s = torch.zeros(N, **f64)
    assign_mat = torch.empty((T, N), **i32)
    regions = torch.arange(R, **i32)
    if cap is not None:
        cap_t = torch.as_tensor(cap, **i32)
        occ = torch.as_tensor(np.bincount(assign0, minlength=R), **i32)
    if has_faults:
        bb = int(faults.migration.backoff_base)
        bc = int(faults.migration.backoff_cap)
        fail_t = torch.as_tensor(fail_mat, device=dev)
        fail_cnt = torch.zeros(N, **i64)
        retry_at = torch.zeros(N, **i64)
        failed_migrations = torch.zeros(N, **i64)

    for n in range(T):
        c_row = cm[n]                                    # (R,)
        p_est = base_b + span_b * torch.clamp(divide(dem[n], mult_b),
                                              max=1.0)
        c_cur = c_row[assign]
        save = divide(p_est[:, None] * (c_cur[:, None] - c_row[None, :]),
                      1000.0) * h_hr
        cost = divide(cost0_t[:, None]
                      * (0.5 * (c_cur[:, None] + c_row[None, :])), 1000.0)
        net = save - hk * cost                           # (N, R)
        eligible = dwell >= min_dwell
        if has_faults:
            eligible = eligible & (retry_at <= n)       # backing off
        if cap is None:
            best, net_best = _prefer(net, torch.zeros(N, **i32))
            dst = torch.where(eligible & (net_best > 0.0) & (best != assign),
                              best, -1)
        else:
            dst, _, _ = admission_rounds(
                net, assign, eligible, torch.full((N,), -1, **i32),
                torch.zeros(N, **i32), cap_t - occ, R)
        attempted = dst >= 0
        if has_faults:
            failed = attempted & fail_t[n]
            moved = attempted & ~failed
        else:
            moved = attempted
        dst_c = torch.where(attempted, dst, 0)
        c_dst = c_row[dst_c]
        # every attempt, failed or not, pays stop-and-copy
        overhead_g = overhead_g + torch.where(
            attempted, divide(cost0_t * (0.5 * (c_cur + c_dst)), 1000.0),
            0.0)
        downtime_s = downtime_s + torch.where(attempted, mig_s_t, 0.0)
        migrations = migrations + moved
        if has_faults:
            failed_migrations = failed_migrations + failed
            fail_cnt = torch.where(failed, fail_cnt + 1,
                                   torch.where(moved, 0, fail_cnt))
            k = torch.clamp(fail_cnt - 1, min=0, max=20)
            delay = torch.clamp(bb * torch.pow(2, k), max=bc)
            retry_at = torch.where(failed, n + 1 + delay, retry_at)
        if cap is not None:
            src_oh = moved[:, None] & (assign[:, None] == regions[None, :])
            dst_oh = moved[:, None] & (dst_c[:, None] == regions[None, :])
            occ = (occ - src_oh.sum(dim=0, dtype=torch.int32)
                   + dst_oh.sum(dim=0, dtype=torch.int32))
        assign = torch.where(moved, dst, assign)
        dwell = torch.where(moved, 0, dwell + 1)
        assign_mat[n] = assign

    return PlacementPlan(
        assign=assign_mat.cpu().numpy().astype(np.int64),
        migrations=migrations.cpu().numpy().astype(np.int64),
        overhead_g=overhead_g.cpu().numpy(),
        downtime_s=downtime_s.cpu().numpy(),
        region_intensity=cmat,
        region_names=engine.region_names,
        initial=assign0.copy(),
        failed_migrations=(failed_migrations.cpu().numpy()
                           if has_faults else None))
