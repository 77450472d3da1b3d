"""Carbon enforcement policies (paper §3.2) + evaluation baselines (§5.1.2).

All policies share one decision interface:

    decide(family, state, demand, c_intensity, target, eps) -> Action

``demand`` is workload intensity in baseline-capacity units (the paper's
normalized utilization; >1 means the job would use more than the baseline
server). Decisions are taken once per monitoring interval (5 min default).

The general policy (§3.2.1), faithfully:
  - trigger when C(t) comes within ε of C_target;
  - first vertically scale down (cheapest mechanism); in parallel estimate
    C_j on the next-smaller slice and migrate when the smaller slice emits
    less *and* throttles no more than the scaled-down larger slice;
  - suspend only when the smallest slice, fully scaled down, still exceeds
    the target (its baseload floor);
  - scale up / migrate up when below target and throttled.

Energy-efficiency variant (§3.2.2): additionally migrates down whenever a
smaller slice serves the current demand unthrottled with less power — even
when far below the carbon target.

Performance variant (§3.2.3): never migrates down for efficiency; instead
scales *up* toward the largest slice whose at-demand emissions stay within
ε of the target, holding reserve capacity for bursts.

Host Python and numpy, copied from `repro.core.policy` with every
expression in the reference's order, so `decide` and `decide_batch` give
the reference's bits. The device fleet scan (`repro_torch.core.fleet`)
has its own decision kernels for the stock classes, which read the
fields below; any other policy runs its `decide_batch` here, on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.cluster.slices import FamilyTables, SliceFamily
from repro_torch.core.container import ContainerState, PlantModel


# ---------------------------------------------------------------------------
# Actions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Action:
    kind: str                       # stay | migrate | suspend | resume
    duty: float = 1.0
    target_slice: Optional[int] = None


# integer action codes for the vectorized (fleet) decision kernels
K_STAY, K_MIGRATE, K_SUSPEND, K_RESUME = 0, 1, 2, 3


def _power_budget_w(target: float, c_intensity: float, eps: float) -> float:
    """Max power keeping C = p*c/1000 <= (1-eps)*target."""
    if c_intensity <= 0:
        return float("inf")
    return (1.0 - eps) * target * 1000.0 / c_intensity


# ---------------------------------------------------------------------------
# Vectorized building blocks (fleet path)
#
# Each helper mirrors its scalar counterpart term-for-term so that a fleet
# of N containers advances bit-identically to N scalar simulations.
# ---------------------------------------------------------------------------

def _budget_batch(target, c, eps):
    """Vectorized `_power_budget_w` over per-container (target, c, eps)."""
    c_safe = np.where(c <= 0.0, 1.0, c)
    return np.where(c <= 0.0, np.inf, (1.0 - eps) * target * 1000.0 / c_safe)


def _power_batch(t: FamilyTables, idx, util):
    """LinearPowerModel.power for slice indices `idx` at `util`."""
    b = t.base_w[idx]
    u = np.minimum(np.maximum(util, 0.0), 1.0)
    return b + (t.peak_w[idx] - b) * u


def _util_for_power_batch(t: FamilyTables, idx, watts):
    """LinearPowerModel.util_for_power for slice indices `idx`."""
    b = t.base_w[idx]
    p = t.peak_w[idx]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.minimum(1.0, (watts - b) / (p - b))
    u = np.where(p <= b, 1.0, u)
    return np.where(watts <= b, 0.0, u)


def _best_fit_up_batch(t: FamilyTables, i, demand, budget, active0=None):
    """Vectorized `_best_fit_up`: smallest larger slice serving `demand`
    within `budget`, walking the same next-larger chain as the scalar loop
    (including its give-up-on-first-overbudget semantics). Returns -1 where
    no fit exists. `active0` restricts the walk to the (typically sparse)
    subset of containers that need it — the walk then runs compacted."""
    res = np.full(i.shape, -1, dtype=np.int64)
    if active0 is not None:
        idx = np.flatnonzero(active0)
        if idx.size == 0:
            return res
        sub = _best_fit_up_batch(t, i[idx], demand[idx], budget[idx])
        res[idx] = sub
        return res
    k = t.next_larger[i]
    active = k >= 0
    kk = np.where(active, k, 0)
    for _ in range(len(t.multiple)):
        if not np.count_nonzero(active):
            break
        u_k = np.minimum(demand / t.multiple[kk], 1.0)
        fits = _power_batch(t, kk, u_k) <= budget
        nl_k = t.next_larger[kk]
        final = fits & ((demand <= t.multiple[kk]) | (nl_k < 0))
        res = np.where(active & final, kk, res)
        cont = active & fits & ~final          # demand > capacity, larger exists
        kk = np.where(cont, nl_k, kk)
        active = cont
    return res


# ---------------------------------------------------------------------------
# The Carbon Containers policy (both variants)
# ---------------------------------------------------------------------------

@dataclass
class CarbonContainerPolicy:
    variant: str = "energy"          # energy | performance
    allow_migration: bool = True
    min_dwell: int = 2               # intervals between migrations (anti-thrash)
    idle_margin: float = 0.02        # EE idle-migration power improvement margin

    def decide(self, family: SliceFamily, state: ContainerState,
               demand: float, c: float, target: float, eps: float) -> Action:
        budget_w = _power_budget_w(target, c, eps)
        i = state.slice_idx
        s_i = family[i]
        # efficiency-motivated moves wait out the dwell (anti-thrash);
        # enforcement- and throttle-motivated moves react immediately
        can_migrate = self.allow_migration
        can_migrate_idle = (self.allow_migration and state.dwell >= self.min_dwell)

        # --- suspended: resume when the smallest slice fits the budget ----
        if state.suspended:
            j = family.smallest()
            s_j = family[j]
            u_cap_j = s_j.power.util_for_power(budget_w)
            if s_j.power.base_w <= budget_w and u_cap_j > 0.0:
                return Action("resume", duty=u_cap_j, target_slice=j)
            return Action("suspend")

        u_cap_i = s_i.power.util_for_power(budget_w)       # duty cap on i
        u_need_i = min(demand / s_i.multiple, 1.0)         # duty to serve demand

        # --- over / near target: enforce (§3.2.1) --------------------------
        if (s_i.power.power(u_need_i) > budget_w) or (s_i.power.base_w > budget_w):
            if s_i.power.base_w > budget_w or u_cap_i <= 0.0:
                # even idle exceeds the budget on this slice
                j = family.next_smaller(i) if can_migrate else None
                if j is not None:
                    s_j = family[j]
                    if s_j.power.base_w <= budget_w:
                        u_cap_j = s_j.power.util_for_power(budget_w)
                        return Action("migrate", duty=max(u_cap_j, 0.0),
                                      target_slice=j)
                    # fall through toward smallest
                    return Action("migrate", duty=0.0, target_slice=j)
                if i == family.smallest() or not self.allow_migration:
                    return Action("suspend")
                return Action("stay", duty=0.0)
            # vertical scale down to the cap; consider the next-smaller slice
            q_new = u_cap_i
            throttle_i = max(0.0, demand - s_i.multiple * q_new)
            c_i = PlantModel.rate(s_i.power.power(min(q_new, u_need_i)), c)
            j = family.next_smaller(i) if can_migrate else None
            if j is not None:
                s_j = family[j]
                u_cap_j = s_j.power.util_for_power(budget_w)
                u_j = min(demand / s_j.multiple, u_cap_j, 1.0)
                throttle_j = max(0.0, demand - s_j.multiple * u_j)
                c_j = PlantModel.rate(s_j.power.power(u_j), c)
                # paper: migrate when the smaller slice emits less and
                # throttles no more than the vertically-scaled larger slice
                if c_j < c_i and throttle_j <= throttle_i + 1e-12:
                    return Action("migrate", duty=max(u_cap_j, 0.0),
                                  target_slice=j)
            return Action("stay", duty=q_new)

        # --- below target ---------------------------------------------------
        if self.variant == "energy":
            # migrate down when a smaller slice serves the *recent peak*
            # demand unthrottled with less power (baseload amortization,
            # §3.2.2; peak-awareness is the monitor's rolling window and
            # avoids ping-pong on bursty traces)
            peak = max(state.recent_peak, demand)
            j = family.next_smaller(i) if can_migrate_idle else None
            if j is not None:
                s_j = family[j]
                u_cap_j = s_j.power.util_for_power(budget_w)
                u_j = peak / s_j.multiple
                if (u_j <= min(u_cap_j, 0.9)
                        and s_j.power.power(min(u_j, 1.0))
                        < (1.0 - self.idle_margin) * s_i.power.power(u_need_i)):
                    return Action("migrate", duty=min(1.0, max(u_cap_j, 0.0)),
                                  target_slice=j)
            # throttled on a full slice? migrate straight to the best fit
            if demand > s_i.multiple * min(u_cap_i, 1.0):
                if can_migrate:
                    k = self._best_fit_up(family, i, demand, budget_w)
                    if k is not None:
                        return Action("migrate", duty=1.0, target_slice=k)
                return Action("stay", duty=min(1.0, u_cap_i))
            return Action("stay", duty=min(1.0, u_cap_i))

        # performance variant (§3.2.3): hold capacity near the target;
        # up-moves need 10% budget headroom (hysteresis vs hourly c(t) noise)
        k = i
        while can_migrate_idle:
            nxt = family.next_larger(k)
            if nxt is None:
                break
            s_n = family[nxt]
            u_n = min(demand / s_n.multiple, 1.0)
            if s_n.power.power(u_n) <= 0.9 * budget_w:
                k = nxt
            else:
                break
        if k != i:
            return Action("migrate", duty=1.0, target_slice=k)
        return Action("stay", duty=min(1.0, u_cap_i))

    def decide_batch(self, t: FamilyTables, state, demand, c, target, eps,
                     budget=None):
        """Vectorized `decide` over N containers.

        `state` exposes (N,) arrays: slice_idx, suspended, dwell,
        recent_peak. Returns (kind, duty, target_slice) as (N,) arrays with
        kind in {K_STAY, K_MIGRATE, K_SUSPEND, K_RESUME} and target_slice
        -1 where the action carries none. Branches are resolved with masks
        in the exact order of the scalar return statements (`decided`
        tracks which containers already hit an earlier return site).
        `budget` may carry a precomputed `_budget_batch(target, c, eps)`
        row (the fleet loop hoists it out of the time loop).

        `demand` must be non-negative (FleetSimulator.run enforces this):
        inverse-power caps (u_cap_*) are in [0, 1] by construction and
        demand-derived utilizations are then in [0, 1] too, so the scalar
        path's max(., 0)/min(1., .) clamps are exact identities and elided.
        Degenerate (peak <= base) power curves divide by zero here; the
        np.where fixups keep the values correct and FleetSimulator.run
        suppresses the warnings (scalar-equivalent behaviour).
        """
        n = demand.shape[0]
        if budget is None:
            budget = _budget_batch(target, c, eps)
        i = state.slice_idx
        base_i = t.base_w[i]
        peak_i = t.peak_w[i]
        span_i = peak_i - base_i
        mult_i = t.multiple[i]
        can_mig = bool(self.allow_migration)

        # output/bookkeeping scratch, reused across calls (contents are
        # valid until the next decide_batch call on this policy object)
        sc = getattr(self, "_scratch", None)
        if sc is None or sc[0].shape[0] != n:
            sc = (np.empty(n, dtype=np.int64), np.empty(n, dtype=np.float64),
                  np.empty(n, dtype=np.int64), np.empty(n, dtype=bool))
            self._scratch = sc
        kind, duty, tgt, decided = sc
        kind.fill(K_STAY)
        duty.fill(0.0)
        tgt.fill(-1)
        decided.fill(False)

        # --- suspended: resume when the smallest slice fits the budget ----
        sus_any = np.count_nonzero(state.suspended)
        if sus_any:
            j0 = t.smallest
            u_cap_j0 = _util_for_power_batch(t, j0, budget)
            m = state.suspended & (t.base_w[j0] <= budget) & (u_cap_j0 > 0.0)
            kind[m] = K_RESUME
            np.copyto(duty, u_cap_j0, where=m)
            tgt[m] = j0
            m = state.suspended & ~m
            kind[m] = K_SUSPEND
            decided |= state.suspended

        # inline power / inverse-power on cached (base, span) gathers —
        # identical term order to LinearPowerModel.power/util_for_power
        # (for well-formed families the peak<=base fixup is an identity)
        ns = t.next_smaller[i]
        has_j = ns >= 0
        jj = np.where(has_j, ns, 0)
        base_j = t.base_w[jj]
        peak_j = t.peak_w[jj]
        span_j = peak_j - base_j
        mult_j = t.multiple[jj]
        u_cap_i = np.minimum(1.0, (budget - base_i) / span_i)
        if not t.well_formed:
            u_cap_i = np.where(peak_i <= base_i, 1.0, u_cap_i)
        u_cap_i = np.where(budget <= base_i, 0.0, u_cap_i)
        u_cap_j = np.minimum(1.0, (budget - base_j) / span_j)
        if not t.well_formed:
            u_cap_j = np.where(peak_j <= base_j, 1.0, u_cap_j)
        u_cap_j = np.where(budget <= base_j, 0.0, u_cap_j)
        u_need_i = np.minimum(demand / mult_i, 1.0)
        pw_need_i = base_i + span_i * u_need_i
        base_over = base_i > budget
        over = (pw_need_i > budget) | base_over

        # --- over target, even idle exceeds the budget on this slice ------
        hard = over & (base_over | (u_cap_i <= 0.0))
        if sus_any:
            hard &= ~decided
        if np.count_nonzero(hard):
            if can_mig:
                m = hard & has_j & (base_j <= budget)
                kind[m] = K_MIGRATE
                np.copyto(duty, u_cap_j, where=m)
                np.copyto(tgt, jj, where=m)
                decided |= m
                m = hard & has_j & ~decided        # fall through toward smallest
                kind[m] = K_MIGRATE
                np.copyto(tgt, jj, where=m)
                decided |= m
                m = hard & ~has_j & (i == t.smallest)
                kind[m] = K_SUSPEND
                decided |= m
                decided |= hard                    # remainder: stay, duty 0
            else:
                kind[hard] = K_SUSPEND
                decided |= hard

        # --- over target: vertical scale down; consider next smaller ------
        soft = over & ~decided
        q_new = u_cap_i
        if np.count_nonzero(soft):
            if can_mig:
                throttle_i = np.maximum(0.0, demand - mult_i * q_new)
                u_qi = np.minimum(q_new, u_need_i)
                c_i = (base_i + span_i * u_qi) * c / 1000.0
                u_j = np.minimum(np.minimum(demand / mult_j, u_cap_j), 1.0)
                throttle_j = np.maximum(0.0, demand - mult_j * u_j)
                c_j = (base_j + span_j * u_j) * c / 1000.0
                m = (soft & has_j & (c_j < c_i)
                     & (throttle_j <= throttle_i + 1e-12))
                kind[m] = K_MIGRATE
                np.copyto(duty, u_cap_j, where=m)
                np.copyto(tgt, jj, where=m)
                decided |= m
            m = soft & ~decided
            np.copyto(duty, q_new, where=m)        # kind stays K_STAY
            decided |= m

        below = ~decided
        if self.variant == "energy":
            if can_mig:
                can_idle = state.dwell >= self.min_dwell
                peak = np.maximum(state.recent_peak, demand)
                u_jp = peak / mult_j
                pw_jp = base_j + span_j * np.minimum(u_jp, 1.0)
                m = (below & can_idle & has_j
                     & (u_jp <= np.minimum(u_cap_j, 0.9))
                     & (pw_jp < (1.0 - self.idle_margin) * pw_need_i))
                if np.count_nonzero(m):
                    kind[m] = K_MIGRATE
                    np.copyto(duty, u_cap_j, where=m)
                    np.copyto(tgt, jj, where=m)
                    decided |= m
                throttled = below & ~decided & (demand > mult_i * u_cap_i)
                if np.count_nonzero(throttled):
                    k_up = _best_fit_up_batch(t, i, demand, budget,
                                              active0=throttled)
                    m = throttled & (k_up >= 0)
                    kind[m] = K_MIGRATE
                    duty[m] = 1.0
                    np.copyto(tgt, k_up, where=m)
                    decided |= m
            m = below & ~decided
            np.copyto(duty, u_cap_i, where=m)      # kind stays K_STAY
        else:
            # performance: climb while the larger slice fits 0.9x budget
            k = i.copy()
            climbing = below & can_mig & (state.dwell >= self.min_dwell)
            for _ in range(len(t.multiple)):
                if not np.count_nonzero(climbing):
                    break
                nxt = t.next_larger[k]
                has = climbing & (nxt >= 0)
                kk = np.where(has, nxt, 0)
                u_n = np.minimum(demand / t.multiple[kk], 1.0)
                ok = has & (_power_batch(t, kk, u_n) <= 0.9 * budget)
                k = np.where(ok, kk, k)
                climbing = ok
            m = below & (k != i)
            kind[m] = K_MIGRATE
            duty[m] = 1.0
            np.copyto(tgt, k, where=m)
            m = below & (k == i)
            np.copyto(duty, u_cap_i, where=m)      # kind stays K_STAY
        return kind, duty, tgt

    @staticmethod
    def _best_fit_up(family: SliceFamily, i: int, demand: float,
                     budget_w: float):
        """Smallest larger slice that serves `demand` within the budget."""
        k = family.next_larger(i)
        while k is not None:
            s_k = family[k]
            u_k = min(demand / s_k.multiple, 1.0)
            if s_k.power.power(u_k) <= budget_w:
                if demand <= s_k.multiple or family.next_larger(k) is None:
                    return k
                k = family.next_larger(k)
                continue
            return None
        return None


# ---------------------------------------------------------------------------
# Baselines (paper §5.1.2)
# ---------------------------------------------------------------------------

@dataclass
class CarbonAgnosticPolicy:
    """Baseline server, no scaling, no migration, never suspends."""

    def decide(self, family, state, demand, c, target, eps) -> Action:
        if state.slice_idx != family.baseline_idx:
            return Action("migrate", duty=1.0, target_slice=family.baseline_idx)
        return Action("stay", duty=1.0)

    def decide_batch(self, t: FamilyTables, state, demand, c, target, eps,
                     budget=None):
        n = demand.shape[0]
        kind = np.zeros(n, dtype=np.int64)           # default: K_STAY
        duty = np.ones(n, dtype=np.float64)
        tgt = np.full(n, -1, dtype=np.int64)
        off_base = state.slice_idx != t.baseline_idx
        if np.count_nonzero(off_base):
            kind[off_base] = K_MIGRATE
            tgt[off_base] = t.baseline_idx
        return kind, duty, tgt


@dataclass
class SuspendResumePolicy:
    """Wait-AWhile-style [34]: baseline server; suspend when emissions at the
    current demand would exceed the target, resume when they fit."""

    def decide(self, family, state, demand, c, target, eps) -> Action:
        b = family[family.baseline_idx]
        u = min(demand / b.multiple, 1.0)
        over = PlantModel.rate(b.power.power(u), c) > (1.0 - eps) * target
        if state.suspended:
            if not over:
                return Action("resume", duty=1.0,
                              target_slice=family.baseline_idx)
            return Action("suspend")
        if over:
            return Action("suspend")
        return Action("stay", duty=1.0)

    def decide_batch(self, t: FamilyTables, state, demand, c, target, eps,
                     budget=None):
        b = t.baseline_idx
        u = np.minimum(demand / t.multiple[b], 1.0)
        pw = _power_batch(t, b, u)
        over = pw * c / 1000.0 > (1.0 - eps) * target
        kind = np.where(over, K_SUSPEND,
                        np.where(state.suspended, K_RESUME, K_STAY))
        duty = np.ones(demand.shape[0], dtype=np.float64)
        tgt = np.where(kind == K_RESUME, b, -1)
        return kind, duty, tgt


def VScaleOnlyPolicy(variant: str = "energy") -> CarbonContainerPolicy:
    """Carbon Containers without migration (vertical scaling + suspend)."""
    return CarbonContainerPolicy(variant=variant, allow_migration=False)
