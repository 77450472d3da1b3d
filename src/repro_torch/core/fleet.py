"""Fleet simulator on a device: N Carbon Containers advanced in lockstep.

Ports `repro.core.fleet_jax` (the scan and its policy decision kernels)
and the parts of `repro.core.fleet` that frame it (`FleetResult`, the
run and sweep prologues, the sweep-row aggregation). The epoch loop is a
Python loop over T epochs of device-side tensor ops, float64 on the card
as on the CPU, with no host sync inside the loop.

Each step mirrors the reference scan term for term, so the port keeps
its parity (<= 1e-6 relative, discrete outcomes exact):

  - the policy decision kernels evaluate every branch masked, in the
    scalar code's return order (`_decide_cc`, `_decide_sr`,
    `_decide_agnostic`);
  - slice-table lookups are gathers from the family's device tables
    (`FamilyTables.to`);
  - the accounting accumulates raw per-step sums and applies the
    loop-invariant ``dt / 3600 / 1000`` scalings once after the loop;
    time on each slice and suspended time are int32 interval counters.

Carbon comes dense — (T,) or (T, N) — or indexed: a placement plan's
``(region_mat (T, R), codes (T, n_cols))`` pair with compact (T, n_cols)
demand and ``n_rep`` target replicas. Indexed runs keep the fleet state
as (n_rep, n_cols) and broadcast each epoch's compact demand and carbon
rows over it, so no (T, N) input and no per-step (N,) copy of the
compact rows exists.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.migration import MigrationCostModel
from repro_torch.cluster.placement import plan_torch
from repro_torch.cluster.slices import FamilyTables, SliceFamily
from repro_torch.core.policy import (K_MIGRATE, K_RESUME, K_STAY, K_SUSPEND,
                                     CarbonAgnosticPolicy,
                                     CarbonContainerPolicy,
                                     SuspendResumePolicy)
from repro_torch.core.simulator import SimConfig
from repro_torch.device import resolve_device

_PEAK_WINDOW = 6          # rolling demand-peak window (ContainerState default)


def _not_yet(**layers):
    """Raise for a layer a later slice of the port brings (ROADMAP.md,
    Queue 1)."""
    fault = "9 (fault split and planner retry carry)"
    items = {"traffic": "10 (traffic fold)", "energy": "11 (energy fold)",
             "elasticity": "12 (elasticity scan)", "faults": fault,
             "carbon_obs": fault, "power_gap": fault}
    for name, value in layers.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet (ROADMAP.md Queue 1 item "
                f"{items[name]})")


@dataclass
class FleetResult:
    """Per-container result arrays (host numpy)."""
    emissions_g: np.ndarray
    energy_wh: np.ndarray
    work_done: np.ndarray
    work_demanded: np.ndarray
    throttled_integral: np.ndarray
    migrations: np.ndarray
    suspended_s: np.ndarray
    elapsed_s: np.ndarray
    time_on_slice_s: np.ndarray          # (N, S+1); last column = suspended
    slice_names: tuple                   # S names + ("suspended",)
    baseline_cap: float
    power_series: Optional[np.ndarray] = None   # (T, N) when record=True
    served_series: Optional[np.ndarray] = None  # (T, N) when record=True

    @property
    def hours(self) -> np.ndarray:
        return self.elapsed_s / 3600.0

    @property
    def avg_carbon_rate(self) -> np.ndarray:
        return self.emissions_g / np.maximum(self.hours, 1e-12)

    @property
    def avg_throttle_pct(self) -> np.ndarray:
        return (100.0 * self.throttled_integral
                / np.maximum(self.elapsed_s, 1e-9) / self.baseline_cap)

    @property
    def suspended_frac(self) -> np.ndarray:
        return self.suspended_s / np.maximum(self.elapsed_s, 1e-9)


def _carbon_matrix(carbon, T: int, interval_s: float):
    """(T,) or (T, N) intensity values at each interval start."""
    if isinstance(carbon, np.ndarray):
        return carbon
    t = np.arange(T, dtype=np.float64) * interval_s
    return carbon.intensity_series(t)


def _prepare_run_inputs(demand, carbon, targets, epsilon, state_gb,
                        demand_scale, interval_s: float):
    """Dense `run()` prologue: demand shaping and validation, carbon
    matrix resolution, per-container broadcasts."""
    demand = np.asarray(demand, dtype=np.float64)
    if demand.ndim == 1:
        demand = demand[:, None]
    T, N = demand.shape
    if demand_scale is not None and np.any(np.asarray(demand_scale) != 1.0):
        demand = demand * demand_scale
    if demand.size and demand.min() < 0.0:
        raise ValueError("fleet demand must be non-negative")
    cmat = np.asarray(_carbon_matrix(carbon, T, interval_s),
                      dtype=np.float64)
    if cmat.ndim not in (1, 2) or cmat.shape[0] != T or (
            cmat.ndim == 2 and cmat.shape[1] != N):
        raise ValueError(f"carbon matrix shape {cmat.shape} does not "
                         f"match demand (T={T}, N={N}); expected (T,) "
                         f"or (T, N)")
    targets = np.broadcast_to(np.asarray(targets, dtype=np.float64), (N,))
    epsilon = np.broadcast_to(np.asarray(epsilon, dtype=np.float64), (N,))
    state_gb = np.broadcast_to(np.asarray(state_gb, dtype=np.float64), (N,))
    return demand, cmat, targets, epsilon, state_gb, T, N


# ---------------------------------------------------------------------------
# Decision kernels (the policies' batch decisions, on device tensors)
# ---------------------------------------------------------------------------

def _policy_spec(policy) -> tuple:
    if type(policy) is CarbonAgnosticPolicy:
        return ("agnostic",)
    if type(policy) is SuspendResumePolicy:
        return ("suspend_resume",)
    if type(policy) is CarbonContainerPolicy:
        return ("cc", policy.variant, bool(policy.allow_migration),
                int(policy.min_dwell), float(policy.idle_margin))
    raise NotImplementedError(
        f"the torch fleet scan has no decision kernel for "
        f"{type(policy).__name__}: custom policies are not ported yet "
        f"(ROADMAP.md Queue 1 item 2), stock policies only")


def _nl_chain(tb: FamilyTables, i: int) -> list:
    """Next-larger chain upward from slice i (exclusive)."""
    chain = []
    k = int(tb.next_larger[i])
    while k >= 0:
        chain.append(k)
        k = int(tb.next_larger[k])
    return chain


def _u_cap(budget, base, peak, well_formed: bool):
    """LinearPowerModel.util_for_power over tensors (duty cap)."""
    u = torch.clamp((budget - base) / (peak - base), max=1.0)
    if not well_formed:
        u = torch.where(peak <= base, 1.0, u)
    return torch.where(budget <= base, 0.0, u)


def _best_fit_up(tb: FamilyTables, i0, demand, budget):
    """Smallest larger slice serving `demand` within `budget` along the
    next-larger chain (give up at the first over-budget slice); -1 where
    none fits. The chain is a property of the family, so it is unrolled
    here with per-slice constants."""
    fits, geq = [], []
    for s in range(len(tb.multiple)):
        m_s = float(tb.multiple[s])
        b_s = float(tb.base_w[s])
        u_s = torch.clamp(demand / m_s, max=1.0)
        fits.append(b_s + (float(tb.peak_w[s]) - b_s) * u_s <= budget)
        geq.append(demand <= m_s)
    res = torch.full(i0.shape, -1, dtype=torch.int64, device=i0.device)
    for i in range(len(tb.multiple)):
        chain = _nl_chain(tb, i)
        if not chain:
            continue
        # walk outcome from start i, built from the chain's end backward:
        # at k: not fits -> -1; fits and (serves | last) -> k; else next
        last = chain[-1]
        r = torch.where(fits[last], last, -1)
        for k in reversed(chain[:-1]):
            r = torch.where(fits[k], torch.where(geq[k], k, r), -1)
        res = torch.where(i0 == i, r, res)
    return res


def _decide_cc(spec, tb, ts, i0, sus, dwell, peak_r, d, c, budget):
    """CarbonContainerPolicy's batch decision: branch masks in the
    scalar code's return order, then kind / duty / target selects."""
    _, variant, can_mig, min_dwell, idle_margin = spec
    base_i = ts.base_w[i0]
    peak_i = ts.peak_w[i0]
    mult_i = ts.multiple[i0]
    ns = ts.next_smaller[i0]
    has_j = ns >= 0
    jj = torch.clamp(ns, min=0)
    base_j = ts.base_w[jj]
    peak_j = ts.peak_w[jj]
    mult_j = ts.multiple[jj]
    span_i = peak_i - base_i
    span_j = peak_j - base_j

    # --- shared float quantities -----------------------------------------
    u_cap_i = _u_cap(budget, base_i, peak_i, tb.well_formed)
    u_cap_j = _u_cap(budget, base_j, peak_j, tb.well_formed)
    u_need_i = torch.clamp(d / mult_i, max=1.0)
    b_j0 = float(tb.base_w[tb.smallest])
    p_j0 = float(tb.peak_w[tb.smallest])
    u_cap_j0 = torch.clamp((budget - b_j0) / (p_j0 - b_j0), max=1.0)
    if not tb.well_formed and p_j0 <= b_j0:
        u_cap_j0 = torch.ones_like(u_cap_j0)
    u_cap_j0 = torch.where(budget <= b_j0, 0.0, u_cap_j0)
    pw_need_i = base_i + span_i * u_need_i

    # --- branch masks, in scalar return order ----------------------------
    resume_ok = sus & (b_j0 <= budget) & (u_cap_j0 > 0.0)
    base_over = base_i > budget
    over = (pw_need_i > budget) | base_over
    hard = over & (base_over | (u_cap_i <= 0.0)) & ~sus
    soft = over & ~hard & ~sus
    if can_mig:
        # soft: emissions/throttle comparison on the next-smaller slice
        q_new = u_cap_i
        throttle_i = torch.clamp(d - mult_i * q_new, min=0.0)
        u_qi = torch.minimum(q_new, u_need_i)
        c_i = (base_i + span_i * u_qi) * c / 1000.0
        u_j = torch.clamp(torch.minimum(d / mult_j, u_cap_j), max=1.0)
        throttle_j = torch.clamp(d - mult_j * u_j, min=0.0)
        c_j = (base_j + span_j * u_j) * c / 1000.0
        s1 = (soft & has_j & (c_j < c_i)
              & (throttle_j <= throttle_i + 1e-12))
    else:
        s1 = torch.zeros_like(soft)
    below = ~over & ~sus
    if variant == "energy":
        if can_mig:
            k_up = _best_fit_up(tb, i0, d, budget)
            can_idle = dwell >= min_dwell
            peak = torch.maximum(peak_r, d)
            u_jp = peak / mult_j
            pw_jp = base_j + span_j * torch.clamp(u_jp, max=1.0)
            e1 = (below & can_idle & has_j
                  & (u_jp <= torch.clamp(u_cap_j, max=0.9))
                  & (pw_jp < (1.0 - idle_margin) * pw_need_i))
            throttled = below & ~e1 & (d > mult_i * u_cap_i)
            e2 = throttled & (k_up >= 0)
    else:
        if can_mig:
            # performance: climb next-larger while the candidate fits
            # 0.9x budget; k_idx is the last accepted slice
            climbing = below & (dwell >= min_dwell)
            ok = []
            for s in range(len(tb.multiple)):
                b_s = float(tb.base_w[s])
                u_n = torch.clamp(d / float(tb.multiple[s]), max=1.0)
                ok.append(b_s + (float(tb.peak_w[s]) - b_s) * u_n
                          <= 0.9 * budget)
            k_is_set = torch.zeros_like(climbing)
            k_idx = torch.zeros(i0.shape, dtype=torch.int64, device=i0.device)
            for i in range(len(tb.multiple)):
                chain = _nl_chain(tb, i)
                if not chain:
                    continue
                reach = climbing
                k_i = torch.full(i0.shape, -1, dtype=torch.int64,
                                 device=i0.device)
                for s in chain:
                    reach = reach & ok[s]
                    k_i = torch.where(reach, s, k_i)
                here = (i0 == i) & (k_i >= 0)
                k_idx = torch.where(here, k_i, k_idx)
                k_is_set = k_is_set | here
            p1 = below & k_is_set
        else:
            p1 = torch.zeros_like(below)
            k_idx = torch.zeros(i0.shape, dtype=torch.int64, device=i0.device)

    # --- kind / duty / target -------------------------------------------
    kind = torch.full(i0.shape, K_STAY, dtype=torch.int64, device=i0.device)
    duty = torch.zeros(i0.shape, dtype=torch.float64, device=i0.device)
    tgt = torch.full(i0.shape, -1, dtype=torch.int64, device=i0.device)
    kind = torch.where(resume_ok, K_RESUME, kind)
    kind = torch.where(sus & ~resume_ok, K_SUSPEND, kind)
    duty = torch.where(resume_ok, u_cap_j0, duty)
    tgt = torch.where(resume_ok, tb.smallest, tgt)
    if can_mig:
        h1 = hard & has_j & (base_j <= budget)
        h_mig = hard & has_j
        h3 = hard & ~has_j & (i0 == tb.smallest)
        kind = torch.where(h_mig, K_MIGRATE, kind)
        kind = torch.where(h3, K_SUSPEND, kind)
        duty = torch.where(h1, u_cap_j, duty)
        tgt = torch.where(h_mig, jj, tgt)
        kind = torch.where(s1, K_MIGRATE, kind)
        duty = torch.where(s1, u_cap_j, duty)
        tgt = torch.where(s1, jj, tgt)
    else:
        kind = torch.where(hard, K_SUSPEND, kind)
    duty = torch.where(soft & ~s1, u_cap_i, duty)       # stay at q_new
    rest = ~sus & ~hard & ~soft
    if variant == "energy":
        if can_mig:
            kind = torch.where(e1 | e2, K_MIGRATE, kind)
            duty = torch.where(e1, u_cap_j, duty)
            duty = torch.where(e2, 1.0, duty)
            tgt = torch.where(e1, jj, tgt)
            tgt = torch.where(e2, k_up, tgt)
            rest = rest & ~e1 & ~e2
        duty = torch.where(rest, u_cap_i, duty)
    else:
        kind = torch.where(p1, K_MIGRATE, kind)
        duty = torch.where(p1, 1.0, duty)
        tgt = torch.where(p1, k_idx, tgt)
        duty = torch.where(rest & ~p1, u_cap_i, duty)
    return kind, duty, tgt


def _decide_sr(spec, tb, ts, i0, sus, dwell, peak, d, c, budget):
    # `budget` is the (1 - eps) * target rate threshold (see _fleet_scan)
    b = tb.baseline_idx
    base_b = float(tb.base_w[b])
    span_b = float(tb.peak_w[b]) - base_b
    u = torch.clamp(d / float(tb.multiple[b]), max=1.0)
    over = (base_b + span_b * u) * c / 1000.0 > budget
    kind = torch.where(over, K_SUSPEND,
                       torch.where(sus, K_RESUME, K_STAY))
    duty = torch.ones(kind.shape, dtype=torch.float64, device=kind.device)
    tgt = torch.where(kind == K_RESUME, b, -1)
    return kind, duty, tgt


def _decide_agnostic(spec, tb, ts, i0, sus, dwell, peak, d, c, budget):
    # baseline server: migrate back if ever off the baseline slice
    off_base = i0 != tb.baseline_idx
    kind = torch.where(off_base, K_MIGRATE, K_STAY)
    duty = torch.ones(i0.shape, dtype=torch.float64, device=i0.device)
    tgt = torch.where(off_base, tb.baseline_idx, -1)
    return kind, duty, tgt


_DECIDERS = {"agnostic": _decide_agnostic, "suspend_resume": _decide_sr,
             "cc": _decide_cc}


# ---------------------------------------------------------------------------
# The epoch loop
# ---------------------------------------------------------------------------

def _fleet_scan(spec, tb: FamilyTables, mig: MigrationCostModel, dt: float,
                srs: bool, record: bool, demand, carbon, targets, eps,
                state_gb, shape, dev):
    """Advance the fleet over all T epochs on `dev`.

    `demand` is the (T, w) device demand; `carbon` is ``("dense", cmat)``
    with cmat (T,) or (T, N), or ``("indexed", region_mat, codes)``.
    `targets`, `eps`, `state_gb` are device tensors of the state
    `shape` ((N,) dense, (n_rep, n_cols) indexed). Returns the host
    accumulators, counters and optional (T, *shape) series.
    """
    ts = tb.to(dev)
    S = len(tb.multiple)
    T = demand.shape[0]
    decide = _DECIDERS[spec[0]]
    f64 = dict(dtype=torch.float64, device=dev)
    # only the energy variant's idle-migration rule reads the rolling
    # demand peak; the window holds the last W-1 demand rows
    use_peak = spec[0] == "cc" and spec[1] == "energy" and spec[2]
    window = deque(torch.zeros(demand.shape[1:], **f64)
                   for _ in range(_PEAK_WINDOW - 1)) if use_peak else None
    no_peak = torch.zeros((), **f64)
    # per-container budget numerator and stop-and-copy terms, hoisted:
    # the same floats the reference forms inside its step
    if spec[0] == "suspend_resume":
        sr_budget = (1.0 - eps) * targets
    else:
        rate_w = (1.0 - eps) * targets * 1000.0
    mig_fixed = ((mig.suspend_base_s + mig.suspend_per_gb_s * state_gb)
                 + (mig.resume_base_s + mig.resume_per_gb_s * state_gb))
    mig_fixed = mig_fixed + (mig.compress_per_gb_s
                             + mig.decompress_per_gb_s) * state_gb
    sg_ratio = state_gb / mig.compression_ratio

    acc = torch.zeros((4, *shape), **f64)   # power*c, power, served, throttled
    duty = torch.ones(shape, **f64)
    migr_s = torch.zeros(shape, **f64)
    i0 = torch.full(shape, tb.baseline_idx, dtype=torch.int64, device=dev)
    mt0 = torch.full(shape, -1, dtype=torch.int64, device=dev)
    dwell = torch.full(shape, 10 ** 6, dtype=torch.int32, device=dev)
    migs = torch.zeros(shape, dtype=torch.int32, device=dev)
    sus = torch.zeros(shape, dtype=torch.bool, device=dev)
    sus_cnt = torch.zeros(shape, dtype=torch.int32, device=dev)
    tos = torch.zeros((S + 1, *shape), dtype=torch.int32, device=dev)
    tos_cols = torch.arange(S + 1, device=dev).view(-1, *([1] * len(shape)))
    if record:
        power_ser = torch.empty((T, *shape), **f64)
        served_ser = torch.empty((T, *shape), **f64)

    for n in range(T):
        d = demand[n]
        if carbon[0] == "indexed":
            c = carbon[1][n][carbon[2][n]]      # (n_cols,) region gather
        else:
            c = carbon[1][n]                    # () or (N,)
        if use_peak:
            peak = d
            for w in window:
                peak = torch.maximum(peak, w)
            window.append(d)
            window.popleft()
        else:
            peak = no_peak
        if spec[0] == "agnostic":
            budget = no_peak
        elif spec[0] == "suspend_resume":
            budget = sr_budget
        else:
            c_safe = torch.where(c <= 0.0, 1.0, c)
            budget = torch.where(c <= 0.0, torch.inf, rate_w / c_safe)
        migm = migr_s > 0.0

        kind, dy, tg = decide(spec, tb, ts, i0, sus, dwell, peak, d, c,
                              budget)
        kind = torch.where(migm, -1, kind)
        dstc = torch.where(kind == K_MIGRATE, tg, 0)
        dstc_m = torch.where(migm, mt0, 0)
        m_sus = kind == K_SUSPEND
        m_res = kind == K_RESUME
        m_stay = kind == K_STAY
        m_mig = kind == K_MIGRATE

        base_i = ts.base_w[i0]
        base_dm = ts.base_w[dstc_m]              # in-flight migration dst
        base_dst = ts.base_w[dstc]               # newly decided dst
        # stop-and-copy time (MigrationCostModel term order, including
        # the zero-bandwidth fallback) + post-decision slice + duty
        bw = torch.maximum(ts.bw_gbps[i0], ts.bw_gbps[dstc])
        bw = torch.where(bw == 0.0, mig.transfer_gbps, bw)
        mig_s = (mig_fixed + sg_ratio / bw) + mig.restore_extra_s
        duty = torch.where(m_res | m_stay | m_mig, dy, duty)
        has_t = m_res & (tg >= 0)
        longm = m_mig & (mig_s >= dt)
        subm = m_mig & ~longm
        idx1 = torch.where(subm | has_t, tg, i0)

        # ---- plant step ---------------------------------------------------
        mult_c = ts.multiple[idx1]
        base_c = ts.base_w[idx1]
        peak_c = ts.peak_w[idx1]
        srv = torch.minimum(d, mult_c * duty)    # duty in [0, 1]
        pw = base_c + (peak_c - base_c) * (srv / mult_c)
        down = torch.clamp(mig_s, max=dt) / dt
        p_mig = base_i + base_dst
        full = m_res | m_stay
        power = torch.where(migm, base_i + base_dm, 0.0)
        if not srs:
            power = torch.where(m_sus, base_i, power)
        power = torch.where(longm, p_mig, power)
        power = torch.where(full, pw, power)
        power = torch.where(subm, down * p_mig + (1.0 - down) * pw, power)
        served = torch.where(full, srv, 0.0)
        served = torch.where(subm, (1.0 - down) * srv, served)

        # ---- accounting: raw per-step sums, scaled after the loop --------
        sus1 = (sus | m_sus) & ~m_res
        tos += torch.where(sus1, S, idx1) == tos_cols
        acc[0] += power * c
        acc[1] += power
        acc[2] += served
        acc[3] += torch.clamp(d - served, min=0.0)
        if record:
            power_ser[n] = power
            served_ser[n] = served

        # ---- migration progress + dwell (after accounting) ----------------
        migr1 = torch.where(longm, mig_s - dt, migr_s)
        migr_s = torch.where(migm, migr1 - dt, migr1)
        done = migm & (migr_s <= 0.0)
        i0 = torch.where(done, mt0, idx1)
        mt0 = torch.where(done, -1, torch.where(longm, tg, mt0))
        dwell = torch.where(subm | done, 0, dwell)
        dwell = dwell + ((kind >= 0) & (kind != K_MIGRATE))
        migs = migs + m_mig
        sus_cnt = sus_cnt + m_sus
        sus = sus1

    flat = lambda x: x.reshape(x.shape[0], -1).cpu().numpy()   # noqa: E731
    out = dict(acc=flat(acc), migrations=migs.reshape(-1).cpu().numpy(),
               sus_cnt=sus_cnt.reshape(-1).cpu().numpy(), tos=flat(tos))
    if record:
        out["power"] = flat(power_ser)
        out["served"] = flat(served_ser)
    return out


class FleetSimulatorTorch:
    """Advance N containers under one stock policy on a device.

    Usage::

        sim = FleetSimulatorTorch(paper_family())
        res = sim.run(policy, demand, carbon, targets=45.0, device="cuda")

    `family` is a `SliceFamily`, or the `FamilyTables` snapshot of one
    (see `repro_torch.convert`).
    """

    def __init__(self, family, interval_s: float = 300.0,
                 suspend_releases_slice: bool = True,
                 migration: Optional[MigrationCostModel] = None):
        self.tables = (family if isinstance(family, FamilyTables)
                       else family.tables())
        self.interval_s = float(interval_s)
        self.suspend_releases_slice = suspend_releases_slice
        self.mig = migration or MigrationCostModel()

    def run(self, policy, demand, carbon, targets, epsilon=0.05,
            state_gb=1.0, demand_scale=1.0, record: bool = False,
            n_rep: int = 1, traffic=None, energy=None, carbon_obs=None,
            power_gap=None, device="cuda") -> FleetResult:
        """Advance the fleet and return its `FleetResult`.

        `carbon` is a provider, a (T,) or (T, N) intensity matrix, or the
        indexed ``(region_mat (T, R), codes (T, n_cols))`` pair; indexed
        runs take compact (T, n_cols) `demand` and tile it ``n_rep``
        times to the fleet width N = n_cols * n_rep (`targets`,
        `epsilon`, `state_gb` are full-N, replica-major).
        """
        dev = resolve_device(device)
        _not_yet(traffic=traffic, energy=energy, carbon_obs=carbon_obs,
                 power_gap=power_gap)
        spec = _policy_spec(policy)
        t = self.tables
        dt = self.interval_s
        f64 = dict(dtype=torch.float64, device=dev)
        if isinstance(carbon, tuple):
            region_mat, codes = carbon
            demand = np.asarray(demand, dtype=np.float64)
            if demand.ndim != 2:
                raise ValueError("indexed-carbon run needs (T, n_cols) "
                                 "demand")
            if demand_scale is not None and np.any(
                    np.asarray(demand_scale) != 1.0):
                demand = demand * demand_scale
            if demand.size and demand.min() < 0.0:
                raise ValueError("fleet demand must be non-negative")
            T, n_cols = demand.shape
            N = n_cols * int(n_rep)
            region_mat = np.asarray(region_mat, dtype=np.float64)
            codes = np.asarray(codes)
            if region_mat.ndim != 2 or region_mat.shape[0] != T:
                raise ValueError(f"region matrix shape {region_mat.shape}"
                                 f" does not match demand (T={T})")
            if codes.shape != (T, n_cols):
                raise ValueError(f"region codes shape {codes.shape} does "
                                 f"not match demand {(T, n_cols)}")
            if codes.size and (codes.min() < 0
                               or codes.max() >= region_mat.shape[1]):
                raise ValueError("region codes out of range")
            shape = (int(n_rep), n_cols)
            carbon_d = ("indexed", torch.as_tensor(region_mat, **f64),
                        torch.as_tensor(codes, dtype=torch.int32,
                                        device=dev))
            per_c = [np.broadcast_to(np.asarray(x, dtype=np.float64), (N,))
                     for x in (targets, epsilon, state_gb)]
        else:
            if n_rep != 1:
                raise ValueError("n_rep tiling requires indexed carbon")
            demand, cmat, *per_c, T, N = _prepare_run_inputs(
                demand, carbon, targets, epsilon, state_gb, demand_scale,
                dt)
            shape = (N,)
            carbon_d = ("dense", torch.as_tensor(cmat, **f64))
        tg_t, eps_t, sg_t = (torch.as_tensor(np.array(x), **f64)
                             .reshape(shape) for x in per_c)
        out = _fleet_scan(spec, t, self.mig, dt, self.suspend_releases_slice,
                          record, torch.as_tensor(demand, **f64), carbon_d,
                          tg_t, eps_t, sg_t, shape, dev)

        acc = out["acc"]
        elapsed = float(np.cumsum(np.full(T, dt))[-1]) if T else 0.0
        work_dem = demand.sum(axis=0) * dt
        if n_rep > 1:
            work_dem = np.tile(work_dem, n_rep)
        # loop-invariant scalings deferred out of the loop, in the
        # reference's term order
        return FleetResult(
            emissions_g=acc[0] / 1000.0 * dt / 3600.0,
            energy_wh=acc[1] * dt / 3600.0,
            work_done=acc[2] * dt,
            work_demanded=work_dem,
            throttled_integral=acc[3] * dt,
            migrations=out["migrations"].astype(np.int64),
            suspended_s=out["sus_cnt"].astype(np.float64) * dt,
            elapsed_s=np.full(N, elapsed),
            time_on_slice_s=np.ascontiguousarray(
                out["tos"].T.astype(np.float64)) * dt,
            slice_names=t.names + ("suspended",),
            baseline_cap=float(t.multiple[t.baseline_idx]),
            power_series=out.get("power"),
            served_series=out.get("served"),
        )


# ---------------------------------------------------------------------------
# Population sweep
# ---------------------------------------------------------------------------

def _prepare_sweep_inputs(traces, carbon, targets, cfg_base, demand_scale,
                          placement, device):
    """Sweep prologue: stack the equal-length traces, tile targets, and,
    with a placement engine, plan the shared region schedule on the real
    n_tr-column fleet. Without placement the demand is tiled to the
    (T, n_tr * n_tg) fleet; with it the demand stays compact and the
    caller feeds the plan's indexed carbon to the simulator. Returns
    (demand_one, tgt_one, carbon, plan, n_tr, n_tg)."""
    if isinstance(traces, np.ndarray) and traces.ndim == 2:
        stack = np.asarray(traces, dtype=np.float64)   # (T, n_tr) direct
    else:
        traces = [np.asarray(tr, dtype=np.float64) for tr in traces]
        lengths = {len(tr) for tr in traces}
        if len(lengths) != 1:
            raise ValueError("the fleet sweep needs equal-length traces; "
                             f"got lengths {sorted(lengths)}")
        stack = np.stack(traces, axis=1)               # (T, n_tr)
    n_tr = stack.shape[1]
    n_tg = len(targets)
    tgt_one = np.repeat(np.asarray(targets, dtype=np.float64), n_tr)
    if placement is None:
        return np.tile(stack, (1, n_tg)), tgt_one, carbon, None, n_tr, n_tg
    if float(placement.interval_s) != float(cfg_base.interval_s):
        raise ValueError(
            f"placement engine plans on interval_s={placement.interval_s} "
            f"but the sweep simulates at interval_s={cfg_base.interval_s}; "
            f"construct the engine with the sweep's interval")
    demand_plan = stack
    if demand_scale is not None and np.any(np.asarray(demand_scale) != 1.0):
        demand_plan = stack * demand_scale
    plan = plan_torch(placement, demand_plan, state_gb=cfg_base.state_gb,
                      device=device)
    return stack, tgt_one, None, plan, n_tr, n_tg


def _aggregate_sweep_rows(policies: dict, results: dict, targets, n_tr: int,
                          plan=None) -> list:
    """Fold per-container FleetResult arrays into the sweep's rows, in the
    reference's order. `results` maps policy name -> (FleetResult,
    column offset)."""
    derived = {}
    for name, (res, off) in results.items():
        if id(res) not in derived:
            el = np.maximum(res.elapsed_s, 1e-9)[:, None]
            tos = res.time_on_slice_s
            derived[id(res)] = (res.avg_carbon_rate, res.avg_throttle_pct,
                                res.suspended_frac,
                                np.where(tos > 0.0, tos / el, 0.0))
    rows = []
    for ti, target in enumerate(targets):
        for name in policies:
            res, off = results[name]
            rates_a, thr_a, susp_a, tos_fr = derived[id(res)]
            sl = slice(off + ti * n_tr, off + (ti + 1) * n_tr)
            rates = rates_a[sl]
            thr = thr_a[sl]
            # mean over containers of the per-container fraction
            fracs = tos_fr[sl].sum(axis=0) / n_tr
            slice_time = {k: float(v)
                          for k, v in zip(res.slice_names, fracs)
                          if v != 0.0}
            row = {
                "policy": name, "target": target,
                "carbon_rate_mean": float(np.mean(rates)),
                "carbon_rate_std": float(np.std(rates)),
                "throttle_mean": float(np.mean(thr)),
                "throttle_std": float(np.std(thr)),
                "migrations_mean": float(np.mean(res.migrations[sl])),
                "suspended_frac_mean": float(np.mean(susp_a[sl])),
                "time_on_slice": slice_time,
            }
            if plan is not None:
                # one shared n_tr-column plan: identical per target
                row["placement_migrations_mean"] = float(
                    np.mean(plan.migrations))
                row["placement_overhead_g_mean"] = float(
                    np.mean(plan.overhead_g))
            rows.append(row)
    return rows


def sweep_population_torch(policies: dict, family: SliceFamily, traces,
                           carbon, targets: Sequence[float],
                           cfg_base: SimConfig, demand_scale: float = 1.0,
                           placement=None, traffic=None, elasticity=None,
                           energy=None, faults=None, device="cuda") -> list:
    """Population sweep on `device`: every (policy x target x trace)
    combination, one fleet run per policy over all (target x trace)
    columns; the same rows, in the same order, as the reference's
    `sweep_population_jax`.

    With `placement` (a `PlacementEngine`), the region plan is computed
    once on the real n_tr-column fleet by `plan_torch` and the fleet runs
    on the plan's indexed carbon: compact (T, n_tr) demand, ``n_rep`` =
    number of targets. Rows then also carry `placement_migrations_mean`
    and `placement_overhead_g_mean`.
    """
    dev = resolve_device(device)
    _not_yet(traffic=traffic, elasticity=elasticity, energy=energy,
             faults=faults)
    demand_one, tgt_one, carbon, plan, n_tr, n_tg = _prepare_sweep_inputs(
        traces, carbon, targets, cfg_base, demand_scale, placement, dev)
    n_rep = 1
    if plan is not None:
        carbon = (plan.region_intensity, plan.assign)
        n_rep = n_tg
    sim = FleetSimulatorTorch(
        family, interval_s=cfg_base.interval_s,
        suspend_releases_slice=cfg_base.suspend_releases_slice)
    results = {}
    for name, mk_policy in policies.items():
        results[name] = (sim.run(mk_policy(), demand_one, carbon, tgt_one,
                                 epsilon=cfg_base.epsilon,
                                 state_gb=cfg_base.state_gb,
                                 demand_scale=demand_scale, n_rep=n_rep,
                                 device=dev), 0)
    return _aggregate_sweep_rows(policies, results, targets, n_tr, plan)
