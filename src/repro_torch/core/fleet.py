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
    time on each slice and suspended time are int32 interval counters;
  - quotients by constants are `devmath.divide` and the energy fold's
    region sums `devmath.ordered_sum`, so the card and the CPU compute
    the same bits (and the same decisions).

Carbon comes dense — (T,) or (T, N) — or indexed: a placement plan's
``(region_mat (T, R), codes (T, n_cols))`` pair with compact (T, n_cols)
demand and ``n_rep`` target replicas. Indexed runs keep the fleet state
as (n_rep, n_cols) and broadcast each epoch's compact demand and carbon
rows over it, so no (T, N) input and no per-step (N,) copy of the
compact rows exists.
"""
from __future__ import annotations

import copy
from collections import deque
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.migration import MigrationCostModel
from repro_torch.cluster.placement import plan_torch
from repro_torch.cluster.slices import FamilyTables, SliceFamily
from repro_torch.core.elasticity import shaped_budget_series
from repro_torch.core.elasticity_torch import simulate_elastic_torch
from repro_torch.core.policy import (K_MIGRATE, K_RESUME, K_STAY, K_SUSPEND,
                                     CarbonAgnosticPolicy,
                                     CarbonContainerPolicy,
                                     SuspendResumePolicy)
from repro_torch.core.simulator import SimConfig
from repro_torch.device import resolve_device
from repro_torch.devmath import divide, ordered_sum
from repro_torch.energy.supply import (EnergySpec, event_matrices,
                                       flex_w_per_unit, simulate_supply,
                                       solar_series)
from repro_torch.energy.supply_torch import energy_step
from repro_torch.robustness.degrade import observe_intensity
from repro_torch.robustness.faults import power_gap_vector
from repro_torch.traffic.arrivals import request_matrix
from repro_torch.traffic.sim import simulate_traffic
from repro_torch.traffic.sim_torch import TrafficSpec, traffic_step

_PEAK_WINDOW = 6          # rolling demand-peak window (ContainerState default)


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
    unmetered_g: Optional[np.ndarray] = None    # (N,) emissions billed during
    #                                             power-telemetry gaps

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
    """The decider of `policy`: a device kernel for exactly the stock
    classes (a subclass may override `decide_batch`), else its own
    `decide_batch` on the host."""
    if type(policy) is CarbonAgnosticPolicy:
        return ("agnostic",)
    if type(policy) is SuspendResumePolicy:
        return ("suspend_resume",)
    if type(policy) is CarbonContainerPolicy:
        return ("cc", policy.variant, bool(policy.allow_migration),
                int(policy.min_dwell), float(policy.idle_margin))
    return ("host", policy)


class _HostDecider:
    """A custom policy's `decide_batch`, called on the host once an epoch,
    as the reference's NumPy fleet backend calls it: slow by design. Each
    epoch copies the state (slice, suspended, dwell, the rolling demand
    peak) and the epoch's demand, carbon and budget rows to the host, and
    the decision's three (N,) arrays (kind, duty, target slice) back to
    the device; copying them also takes them out of the policy's reach,
    since a policy may reuse its return buffers (the reference's
    `decide_batch` does)."""

    def __init__(self, policy, tb: FamilyTables, targets, eps):
        self.policy = policy
        self.tb = tb
        self.targets = targets.reshape(-1).cpu().numpy()
        self.eps = eps.reshape(-1).cpu().numpy()

    def __call__(self, spec, tb, ts, i0, sus, dwell, peak, d, c, budget):
        shape = i0.shape

        def host(x, dtype):        # a copy, on the CPU as on the card
            return np.array(torch.broadcast_to(x, shape).reshape(-1).cpu(),
                            dtype=dtype)
        # the fields of the reference's `_StateView`, in its dtypes
        state = SimpleNamespace(
            slice_idx=host(i0, np.int64), suspended=host(sus, bool),
            dwell=host(dwell, np.int64), recent_peak=host(peak, np.float64))
        # a (T,) carbon row reaches the reference's policy as a float
        c_h = float(c) if c.dim() == 0 else host(c, np.float64)
        kind, duty, tgt = self.policy.decide_batch(
            self.tb, state, host(d, np.float64), c_h, self.targets, self.eps,
            budget=host(budget, np.float64))
        dev = i0.device
        return (torch.tensor(np.asarray(kind), dtype=torch.int64,
                             device=dev).reshape(shape),
                torch.tensor(np.asarray(duty), dtype=torch.float64,
                             device=dev).reshape(shape),
                torch.tensor(np.asarray(tgt), dtype=torch.int64,
                             device=dev).reshape(shape))


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
        u_s = torch.clamp(divide(demand, m_s), max=1.0)
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
    u_cap_j0 = torch.clamp(divide(budget - b_j0, p_j0 - b_j0), max=1.0)
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
        c_i = divide((base_i + span_i * u_qi) * c, 1000.0)
        u_j = torch.clamp(torch.minimum(d / mult_j, u_cap_j), max=1.0)
        throttle_j = torch.clamp(d - mult_j * u_j, min=0.0)
        c_j = divide((base_j + span_j * u_j) * c, 1000.0)
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
                u_n = torch.clamp(divide(d, tb.multiple[s]), max=1.0)
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
    u = torch.clamp(divide(d, tb.multiple[b]), max=1.0)
    over = divide((base_b + span_b * u) * c, 1000.0) > budget
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
                state_gb, shape, dev, traffic=None, energy=None, obs=None,
                gap=None):
    """Advance the fleet over all T epochs on `dev`.

    `demand` is the (T, w) device demand; `carbon` is ``("dense", cmat)``
    with cmat (T,) or (T, N), or ``("indexed", region_mat, codes)``.
    `targets`, `eps`, `state_gb` are device tensors of the state
    `shape` ((N,) dense, (n_rep, n_cols) indexed). Returns the host
    accumulators, counters and optional (T, *shape) series.

    Indexed runs fold two layers into the epoch, in the reference's
    order (demand_scale -> traffic -> energy): `traffic` = (TrafficSpec,
    requests (T, R)) routes and autoscales the epoch's requests by the
    carbon row ((R,) replica carry) and scales each compact demand
    column by its region's serving load; `energy` = (EnergySpec, solar
    (T, R), grid_up (T, R)) sums the columns into the (R,) flexible load,
    advances the supply ((R,) state-of-charge carry), caps each column's
    demand by its region's supply fraction and bills the delivered mix's
    effective intensity. An accumulator row then sums the effective
    demand (`work_demanded`).

    `obs` splits the signal plane from the billing plane: the deciders
    and their budgets read the observed intensity ((T, R) indexed, scaled
    onto the delivered mix by the per-region observed/true ratio when
    the energy layer is on; (T,) or (T, N) dense), the traffic router
    routes on it, and emissions stay billed at `carbon`. `gap` ((T,)
    0/1) marks power-telemetry outage epochs; an accumulator row sums
    their emissions (`unmetered_g`).
    """
    ts = tb.to(dev)
    S = len(tb.multiple)
    T = demand.shape[0]
    if spec[0] == "host":
        decide = _HostDecider(spec[1], tb, targets, eps)
    else:
        decide = _DECIDERS[spec[0]]
    f64 = dict(dtype=torch.float64, device=dev)
    # of the stock policies only the energy variant's idle-migration rule
    # reads the rolling demand peak; a custom policy may read it. The
    # window holds the last W-1 demand rows
    use_peak = (spec[0] == "host"
                or spec[0] == "cc" and spec[1] == "energy" and spec[2])
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
    sg_ratio = divide(state_gb, mig.compression_ratio)

    # power*c, power, served, throttled [, effective demand] [, gap grams]
    layered = traffic is not None or energy is not None
    acc = torch.zeros((4 + layered + (gap is not None), *shape), **f64)
    if traffic is not None:
        tspec, req = traffic
        rep = torch.full((tspec.R,), float(tspec.min_rep), **f64)
    if energy is not None:
        espec, sol, up = energy
        soc = torch.full((sol.shape[1],), espec.soc0_wh, **f64)
        regions = torch.arange(sol.shape[1], device=dev)
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
        obs_row = obs[n] if obs is not None else None
        if carbon[0] == "indexed":
            code = carbon[2][n]
            c_row = carbon[1][n]
            if traffic is not None:
                # the router is a controller: it routes on the observed feed
                rep, t_outs = traffic_step(
                    tspec, rep, req[n], c_row if obs is None else obs_row)
                d = d * t_outs[0][code]
            if energy is not None:
                load_row = ordered_sum(torch.where(
                    code[:, None] == regions, d[:, None], 0.0)) \
                    * espec.load_coef
                c_raw = c_row                   # the grid, before the mix
                soc, e_outs = energy_step(espec, soc, load_row, sol[n],
                                          c_row, up[n])
                cap_row, c_row = e_outs[5], e_outs[6]
                if obs is not None:
                    # the delivered mix as the degraded feed shows it
                    raw_safe = torch.where(c_raw > 0.0, c_raw, 1.0)
                    obs_row = c_row * torch.where(c_raw > 0.0,
                                                  obs_row / raw_safe, 1.0)
                d = d * cap_row[code]
            c = c_row[code]                     # (n_cols,) region gather
            c_dec = c if obs is None else obs_row[code]
        else:
            c = carbon[1][n]                    # () or (N,)
            c_dec = c if obs is None else obs_row
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
            c_safe = torch.where(c_dec <= 0.0, 1.0, c_dec)
            budget = torch.where(c_dec <= 0.0, torch.inf, rate_w / c_safe)
        migm = migr_s > 0.0

        kind, dy, tg = decide(spec, tb, ts, i0, sus, dwell, peak, d, c_dec,
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
        down = divide(torch.clamp(mig_s, max=dt), dt)
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
        if layered:
            acc[4] += d
        if gap is not None:
            # telemetry outage: emissions happen but the meter is blind
            acc[-1] += power * c * gap[n]
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
    """Advance N containers under one policy on a device: a stock policy
    through its decision kernel, any other through its own `decide_batch`
    on the host (`_HostDecider`).

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

        Indexed runs only: `traffic` is a ``(TrafficSpec, requests
        (T, R))`` pair and `energy` an ``(EnergySpec, solar (T, R),
        grid_up (T, R))`` triple, folded into the scan (see
        `_fleet_scan`). `carbon_obs` is the observed intensity the
        policy decides on while emissions are billed at `carbon`: (T, R)
        indexed, (T,) or (T, N) dense. `power_gap` is a (T,) 0/1 vector
        of telemetry-outage epochs; the result then carries
        `unmetered_g`.
        """
        dev = resolve_device(device)
        spec = _policy_spec(policy)
        t = self.tables
        dt = self.interval_s
        f64 = dict(dtype=torch.float64, device=dev)
        indexed = isinstance(carbon, tuple)
        for name, layer in (("traffic", traffic), ("energy", energy)):
            if layer is not None and not indexed:
                raise ValueError(f"{name} fold requires indexed carbon "
                                 f"(region_mat, codes)")
        if indexed:
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
            R = region_mat.shape[1]
            shape = (int(n_rep), n_cols)
            carbon_d = ("indexed", torch.as_tensor(region_mat, **f64),
                        torch.as_tensor(codes, dtype=torch.int32,
                                        device=dev))
            per_c = [np.broadcast_to(np.asarray(x, dtype=np.float64), (N,))
                     for x in (targets, epsilon, state_gb)]
            if traffic is not None:
                t_spec, req = traffic
                req = np.asarray(req, dtype=np.float64)
                if req.shape != (T, R):
                    raise ValueError(f"traffic request tensor shape "
                                     f"{req.shape}; expected {(T, R)}")
                traffic = (t_spec, torch.as_tensor(req, **f64))
            if energy is not None:
                e_spec, solar, up = energy
                solar = np.asarray(solar, dtype=np.float64)
                up = np.asarray(up, dtype=np.float64)
                if solar.shape != (T, R) or up.shape != (T, R):
                    raise ValueError(
                        f"energy solar/grid-up tensor shapes {solar.shape} "
                        f"/ {up.shape}; expected {(T, R)}")
                energy = (e_spec, torch.as_tensor(solar, **f64),
                          torch.as_tensor(up, **f64))
            obs_shapes = ((T, R),)
        else:
            if n_rep != 1:
                raise ValueError("n_rep tiling requires indexed carbon")
            demand, cmat, *per_c, T, N = _prepare_run_inputs(
                demand, carbon, targets, epsilon, state_gb, demand_scale,
                dt)
            shape = (N,)
            carbon_d = ("dense", torch.as_tensor(cmat, **f64))
            obs_shapes = ((T,), (T, N))
        if carbon_obs is not None:
            carbon_obs = np.asarray(carbon_obs, dtype=np.float64)
            if carbon_obs.shape not in obs_shapes:
                raise ValueError(f"observed carbon shape {carbon_obs.shape}"
                                 f"; expected one of {obs_shapes}")
            carbon_obs = torch.as_tensor(carbon_obs, **f64)
        if power_gap is not None:
            power_gap = np.asarray(power_gap, dtype=np.float64)
            if power_gap.shape != (T,):
                raise ValueError(f"power-gap vector shape "
                                 f"{power_gap.shape}; expected {(T,)}")
            power_gap = torch.as_tensor(power_gap, **f64)
        tg_t, eps_t, sg_t = (torch.as_tensor(np.array(x), **f64)
                             .reshape(shape) for x in per_c)
        out = _fleet_scan(spec, t, self.mig, dt, self.suspend_releases_slice,
                          record, torch.as_tensor(demand, **f64), carbon_d,
                          tg_t, eps_t, sg_t, shape, dev, traffic=traffic,
                          energy=energy, obs=carbon_obs, gap=power_gap)

        acc = out["acc"]
        elapsed = float(np.cumsum(np.full(T, dt))[-1]) if T else 0.0
        if traffic is not None or energy is not None:
            # the host demand precedes the layers: the scan summed the
            # effective demand
            work_dem = acc[4] * dt
        else:
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
            unmetered_g=(acc[-1] / 1000.0 * dt / 3600.0
                         if power_gap is not None else None),
        )


# ---------------------------------------------------------------------------
# Population sweep
# ---------------------------------------------------------------------------

class _FaultContext:
    """Materialized signal-plane faults for one sweep (host numpy): the
    degraded `ObservedSignal`, the observed and true (T, R) region
    matrices (or the dense matrices of a placement-free sweep), and the
    (T,) power-telemetry gap vector (None when the plan has no gaps)."""

    __slots__ = ("signal", "obs_reg", "true_reg", "gap_vec", "faults")

    def __init__(self, signal, obs_reg, true_reg, gap_vec, faults):
        self.signal = signal
        self.obs_reg = obs_reg
        self.true_reg = true_reg
        self.gap_vec = gap_vec
        self.faults = faults


def _prepare_sweep_inputs(traces, carbon, targets, cfg_base, demand_scale,
                          placement, plan_fn, energy=None, faults=None):
    """Sweep prologue: stack the equal-length traces, tile targets, and,
    with a placement engine, plan the shared region schedule on the real
    n_tr-column fleet with `plan_fn(engine, demand, faults)`. Without
    placement the demand is tiled to the (T, n_tr * n_tg) fleet; with it
    the demand stays compact and the caller feeds the plan's indexed
    carbon to the simulator (`carbon` comes back None). Returns
    (demand_one, tgt_one, carbon, plan, n_tr, n_tg, grid_up, fault_ctx).

    With `energy` (requires placement) the grid events multiply the
    engine's (T, R) intensity before planning, and the (T, R) `grid_up`
    outage mask comes back for the supply. With `faults` the planner,
    and through `plan.region_intensity` every controller layer, sees the
    degraded observed feed (shocks first, then the degrade ladder), and
    `fault_ctx` carries the observed/true split."""
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
    T = stack.shape[0]
    if energy is not None and placement is None:
        raise ValueError("energy=EnergyConfig(...) requires a placement "
                         "engine (placement=...): the supply side — "
                         "solar, battery, grid events — is per region")
    if placement is None:
        fault_ctx = None
        if faults is not None:
            if carbon is None:
                raise ValueError("faults without a placement engine need "
                                 "an explicit carbon signal to degrade")
            true_mat = _carbon_matrix(carbon, T, cfg_base.interval_s)
            true2 = true_mat if true_mat.ndim == 2 else true_mat[:, None]
            signal = observe_intensity(true2, faults, cfg_base.interval_s)
            obs = (signal.observed if true_mat.ndim == 2
                   else signal.observed[:, 0])
            fault_ctx = _FaultContext(signal, obs, true_mat,
                                      power_gap_vector(faults, T), faults)
            carbon = true_mat
        return (np.tile(stack, (1, n_tg)), tgt_one, carbon, None, n_tr,
                n_tg, None, fault_ctx)
    if float(placement.interval_s) != float(cfg_base.interval_s):
        raise ValueError(
            f"placement engine plans on interval_s={placement.interval_s} "
            f"but the sweep simulates at interval_s={cfg_base.interval_s}; "
            f"construct the engine with the sweep's interval")
    grid_up = fault_ctx = None
    if energy is not None:
        shock_mult, grid_up = event_matrices(energy.events, T,
                                             placement.n_regions)
        raw = placement._region_matrix(T)
        placement = copy.copy(placement)
        placement.regions = raw * shock_mult
    if faults is not None:
        # the TRUE regional signal (after the physical grid shocks); the
        # controller plane sees the degraded feed
        true_reg = placement._region_matrix(T)
        signal = observe_intensity(true_reg, faults, cfg_base.interval_s)
        placement = copy.copy(placement)
        placement.regions = signal.observed
        fault_ctx = _FaultContext(signal, signal.observed, true_reg,
                                  power_gap_vector(faults, T), faults)
    demand_plan = stack
    if demand_scale is not None and np.any(np.asarray(demand_scale) != 1.0):
        demand_plan = stack * demand_scale
    plan = plan_fn(placement, demand_plan, faults)
    return stack, tgt_one, None, plan, n_tr, n_tg, grid_up, fault_ctx


def _prepare_traffic(traffic, plan, T: int, interval_s: float):
    """Traffic prologue: the population's (T, R) request tensor and the
    host traffic pipeline against the plan's region intensity. Returns
    (ArrivalTensor, TrafficResult). Requires a placement plan: routing
    and autoscaling are per region."""
    if plan is None:
        raise ValueError("traffic=TrafficConfig(...) requires a placement "
                         "engine (placement=...): routing and autoscaling "
                         "are per region")
    R = plan.n_regions
    if traffic.population.n_regions != R:
        raise ValueError(f"traffic population spans "
                         f"{traffic.population.n_regions} regions but the "
                         f"placement engine has {R}")
    arr = request_matrix(traffic.population, T, interval_s)
    res = simulate_traffic(arr.requests, plan.region_intensity[:T], traffic,
                           interval_s)
    return arr, res


def _prepare_energy(energy, family, plan, comp, T: int, interval_s: float,
                    grid_up, region_mat=None):
    """Energy prologue: the host supply simulation on the compact fleet's
    per-region flexible load, and the two per-container signals. Returns
    ``(spec, SupplyResult, solar (T, R), cap_cols (T, n_tr), ceff_cols
    (T, n_tr))``. `comp` is the compact demand after demand_scale and the
    traffic modulation. `region_mat` overrides the (T, R) grid intensity
    the supply runs on (under faults, the TRUE one)."""
    R = plan.n_regions
    n_tr = comp.shape[1]
    spec = EnergySpec.from_config(energy, n_tr, R, interval_s,
                                  flex_w_per_unit(family))
    solar = solar_series(energy.solar, T, R, interval_s, spec.solar_peak_w)
    assign = plan.assign[:T]
    load = np.zeros((T, R), dtype=np.float64)
    for r in range(R):
        np.sum(comp, axis=1, where=(assign == r), out=load[:, r])
    load *= spec.load_coef
    grid_c = (plan.region_intensity[:T] if region_mat is None
              else region_mat[:T])
    sres = simulate_supply(load, solar, grid_c, grid_up, spec)
    rows = np.arange(T)[:, None]
    cap_cols = sres.cap_frac[rows, assign]
    ceff_cols = sres.c_eff[rows, assign]
    return spec, sres, solar, cap_cols, ceff_cols


def _elastic_budget_series(plan, T: int, elasticity, interval_s: float):
    """The shaped budget series of the sweep (or None): shaped on the
    placed fleet's mean carbon intensity, gathered from the plan."""
    if not elasticity.shape_budget or elasticity.budget_g_per_epoch is None:
        return None
    dense = plan.region_intensity[np.arange(T)[:, None], plan.assign[:T]]
    return shaped_budget_series(dense.mean(axis=1), elasticity, interval_s)


def _aggregate_sweep_rows(policies: dict, results: dict, targets, n_tr: int,
                          plan=None, traffic_summary=None,
                          elastic_summary=None, energy_summary=None,
                          fault_summary=None) -> list:
    """Fold per-container FleetResult arrays into the sweep's rows, in the
    reference's order. `results` maps policy name -> (FleetResult,
    column offset). The layer summaries are one pass each per sweep and
    identical in every row."""
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
            for summary in (traffic_summary, elastic_summary,
                            energy_summary, fault_summary):
                if summary is not None:
                    row.update(summary)
            if fault_summary is not None and res.unmetered_g is not None:
                row["fault_unmetered_g_mean"] = float(
                    np.mean(res.unmetered_g[sl]))
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

    The layers (each needs placement but `faults`) apply in the
    reference's pinned order, demand_scale -> traffic -> energy ->
    elasticity, and rows gain their `traffic_*`, `energy_*`, `elastic_*`
    and `fault_*` summaries, each computed once per sweep by the host
    pipeline:

      - `traffic` (`repro_torch.traffic.TrafficConfig`): requests are
        routed and autoscaled per epoch, and each container's demand is
        scaled by its region's serving load;
      - `energy` (`repro_torch.energy.EnergyConfig`): grid events shock
        the planner's intensity, each container's demand is capped by
        its region's supply fraction and billed at the delivered mix;
      - `elasticity` (`repro_torch.core.elasticity.ElasticityConfig`):
        `simulate_elastic_torch` allocates levels under the (shaped)
        budget in its own epoch loop; the fleet advances on the served
        demand. With elasticity on, traffic and energy apply on the
        host ahead of it; without it they fold into the fleet scan;
      - `faults` (`repro_torch.robustness.FaultPlan`): every controller
        decides on the degraded observed feed while emissions are billed
        at the true one; planned migrations fail per the seeded mask,
        and telemetry gaps accrue `unmetered_g`.
    """
    dev = resolve_device(device)
    compact = placement is not None
    (demand_one, tgt_one, carbon, plan, n_tr, n_tg, grid_up, fault_ctx) = \
        _prepare_sweep_inputs(
            traces, carbon, targets, cfg_base, demand_scale, placement,
            lambda eng, d, flt: plan_torch(eng, d,
                                           state_gb=cfg_base.state_gb,
                                           faults=flt, device=dev),
            energy=energy, faults=faults)
    n_rep = 1
    carbon_obs = None
    gap_vec = fault_ctx.gap_vec if fault_ctx is not None else None
    if compact:
        if fault_ctx is None:
            carbon = (plan.region_intensity, plan.assign)
        else:
            # bill at the TRUE region intensities; the plan's own table
            # is the observed feed and the scan's decision signal
            carbon = (fault_ctx.true_reg, plan.assign)
            carbon_obs = plan.region_intensity
        n_rep = n_tg
    elif fault_ctx is not None:
        obs = fault_ctx.obs_reg
        carbon_obs = np.tile(obs, (1, n_tg)) if obs.ndim == 2 else obs

    traffic_summary = run_traffic = mod_cols = None
    T = demand_one.shape[0]
    if traffic is not None:
        arr, tres = _prepare_traffic(traffic, plan, T, cfg_base.interval_s)
        traffic_summary = tres.summary()
        if elasticity is None:
            run_traffic = (TrafficSpec.from_config(traffic,
                                                   cfg_base.interval_s),
                           arr.requests)
        if elasticity is not None or energy is not None:
            # the host pipeline ahead of the supply and the forecasters
            # needs the modulation as host floats
            mod = tres.demand_mod(traffic.demand_gain)
            mod_cols = mod[np.arange(T)[:, None], plan.assign[:T]]

    # compact host pipeline, pinned layer order:
    # demand_scale -> traffic -> energy -> elasticity
    comp = None
    if energy is not None or elasticity is not None:
        comp = demand_one
        if demand_scale is not None and np.any(
                np.asarray(demand_scale) != 1.0):
            comp = comp * demand_scale
        if mod_cols is not None:
            comp = comp * mod_cols

    energy_summary = run_energy = None
    ela_forecast = None
    if fault_ctx is not None and compact:
        ela_forecast = plan.region_intensity     # the observed grid
    if energy is not None:
        spec_e, sres, solar_mat, cap_cols, _ = _prepare_energy(
            energy, family, plan, comp, T, cfg_base.interval_s, grid_up,
            region_mat=(fault_ctx.true_reg if fault_ctx is not None
                        else None))
        energy_summary = sres.summary()
        if elasticity is None:
            # folded into the scan, which re-derives the supply on the
            # device from the (traffic-modulated) demand
            run_energy = (spec_e, solar_mat, grid_up)
        else:
            # the cap lands ahead of the elasticity forecasters, on the
            # host; billing and the carbon forecast see the delivered mix
            comp = comp * cap_cols
            carbon = (sres.c_eff, plan.assign)
            if fault_ctx is not None:
                tr = fault_ctx.true_reg[:T]
                safe = np.where(tr > 0.0, tr, 1.0)
                ratio = np.where(tr > 0.0,
                                 fault_ctx.obs_reg[:T] / safe, 1.0)
                carbon_obs = sres.c_eff * ratio
                ela_forecast = carbon_obs

    elastic_summary = None
    if elasticity is not None:
        if plan is None:
            raise ValueError("elasticity requires placement")
        eres = simulate_elastic_torch(
            comp, carbon, elasticity, cfg_base.interval_s,
            budget_series=_elastic_budget_series(plan, T, elasticity,
                                                 cfg_base.interval_s),
            carbon_forecast=ela_forecast, device=dev)
        demand_one = eres.demand_served()
        demand_scale = 1.0          # already applied ahead of the layer
        elastic_summary = eres.summary()

    sim = FleetSimulatorTorch(
        family, interval_s=cfg_base.interval_s,
        suspend_releases_slice=cfg_base.suspend_releases_slice)
    results = {}
    for name, mk_policy in policies.items():
        results[name] = (sim.run(mk_policy(), demand_one, carbon, tgt_one,
                                 epsilon=cfg_base.epsilon,
                                 state_gb=cfg_base.state_gb,
                                 demand_scale=demand_scale, n_rep=n_rep,
                                 traffic=run_traffic, energy=run_energy,
                                 carbon_obs=carbon_obs, power_gap=gap_vec,
                                 device=dev), 0)
    fault_summary = None
    if fault_ctx is not None:
        fault_summary = fault_ctx.signal.summary()
        if plan is not None and plan.failed_migrations is not None:
            fault_summary["fault_failed_migrations_mean"] = float(
                np.mean(plan.failed_migrations))
    return _aggregate_sweep_rows(policies, results, targets, n_tr, plan,
                                 traffic_summary, elastic_summary,
                                 energy_summary, fault_summary)
