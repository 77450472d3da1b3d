"""Graceful degradation: turn the true (T, R) signal into the observed one.

Host numpy, copied from `repro.robustness.degrade`. `observe_intensity`
walks the epochs once with (R,)-shaped state and applies the
`DegradeConfig` ladder per (epoch, region):

    tier 0  fresh sample arrived (possibly noise-corrupted)
    tier 1  hold-last-sample, while its age <= ttl_epochs
    tier 2  causal diurnal prior (per-slot running means over the
            *received* samples) while age <= prior_ttl_epochs
    tier 3  conservative floor: assume the worst intensity `c_max`

The result is an ordinary host array that the planner and the fleet
scan consume as they are given it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.robustness.faults import FaultPlan, carbon_fault_masks

TIER_FRESH, TIER_HOLD, TIER_PRIOR, TIER_FLOOR = 0, 1, 2, 3

# "never sampled" age sentinel: larger than any prior_ttl_epochs but
# safely below int32 overflow even after += T increments
_NEVER = 1_000_000


@dataclass
class ObservedSignal:
    """Degraded (T, R) carbon signal + per-sample provenance."""
    observed: np.ndarray        # (T, R) f64: what the controller sees
    true: np.ndarray            # (T, R) f64: what emissions are billed at
    fresh: np.ndarray           # (T, R) bool: a sample arrived
    age: np.ndarray             # (T, R) int32: epochs since last sample
    tier: np.ndarray            # (T, R) int8: TIER_* used per sample

    def summary(self) -> dict:
        """Flat `fault_*` metrics for sweep rows / benchmark JSON."""
        n = max(self.tier.size, 1)
        tr = np.where(self.true > 0.0, self.true, 1.0)
        rel = np.abs(self.observed - self.true) / tr
        return {
            "fault_stale_frac": float(np.count_nonzero(self.tier > 0) / n),
            "fault_hold_frac": float(
                np.count_nonzero(self.tier == TIER_HOLD) / n),
            "fault_prior_frac": float(
                np.count_nonzero(self.tier == TIER_PRIOR) / n),
            "fault_floor_frac": float(
                np.count_nonzero(self.tier == TIER_FLOOR) / n),
            "fault_max_age": int(np.minimum(self.age,
                                            self.age.shape[0]).max()
                                 if self.age.size else 0),
            "fault_obs_rel_err_mean": float(rel.mean()) if rel.size else 0.0,
            "fault_obs_rel_err_max": float(rel.max()) if rel.size else 0.0,
        }


def observe_intensity(true_mat, plan: FaultPlan,
                      interval_s: float) -> ObservedSignal:
    """Apply the plan's carbon-feed faults + degradation ladder to the
    true (T, R) region-intensity matrix. Strictly causal: the estimate
    at epoch t only reads samples received at epochs <= t (the fresh
    sample at t itself is used at t, matching the epoch-start reading
    convention of `repro_torch.carbon.forecast`)."""
    true_mat = np.asarray(true_mat, dtype=np.float64)
    if true_mat.ndim != 2:
        raise ValueError(f"true intensity matrix must be (T, R); got "
                         f"{true_mat.shape}")
    T, R = true_mat.shape
    deg = plan.degrade
    if deg.mode not in ("ladder", "hold", "conservative"):
        raise ValueError(f"unknown degrade mode {deg.mode!r}; expected "
                         f"'ladder', 'hold' or 'conservative'")
    fresh, noise = carbon_fault_masks(plan, T, R)
    sample = true_mat * noise
    period = max(1, int(round(24 * 3600.0 / float(interval_s))))
    c_max = float(deg.c_max)

    observed = np.empty((T, R), dtype=np.float64)
    tier = np.empty((T, R), dtype=np.int8)
    age = np.empty((T, R), dtype=np.int32)

    last = np.zeros(R, dtype=np.float64)        # last received sample
    age_r = np.full(R, _NEVER, dtype=np.int64)
    slot_sum = np.zeros((period, R), dtype=np.float64)
    slot_cnt = np.zeros((period, R), dtype=np.int64)
    run_sum = np.zeros(R, dtype=np.float64)
    run_cnt = np.zeros(R, dtype=np.int64)

    for t in range(T):
        f = fresh[t]
        age_r = np.where(f, 0, np.minimum(age_r + 1, _NEVER))
        have = run_cnt > 0
        if deg.mode == "conservative":
            est = np.full(R, c_max)
            est_tier = np.full(R, TIER_FLOOR, dtype=np.int8)
        elif deg.mode == "hold":
            est = np.where(have, last, c_max)
            est_tier = np.where(have, TIER_HOLD, TIER_FLOOR).astype(np.int8)
        else:                                    # ladder
            s = t % period
            glob = run_sum / np.maximum(run_cnt, 1)
            mu_slot = np.where(slot_cnt[s] > 0,
                               slot_sum[s] / np.maximum(slot_cnt[s], 1),
                               glob)
            prior_ok = have & (age_r <= deg.prior_ttl_epochs)
            est = np.where(prior_ok, mu_slot, c_max)
            est_tier = np.where(prior_ok, TIER_PRIOR,
                                TIER_FLOOR).astype(np.int8)
            hold_ok = have & (age_r <= deg.ttl_epochs)
            est = np.where(hold_ok, last, est)
            est_tier = np.where(hold_ok, TIER_HOLD, est_tier)
        observed[t] = np.where(f, sample[t], est)
        tier[t] = np.where(f, TIER_FRESH, est_tier)
        age[t] = age_r
        # fold the received samples into the causal state *after* use
        last = np.where(f, sample[t], last)
        s = t % period
        slot_sum[s] += np.where(f, sample[t], 0.0)
        slot_cnt[s] += f
        run_sum += np.where(f, sample[t], 0.0)
        run_cnt += f
    return ObservedSignal(observed=observed, true=true_mat, fresh=fresh,
                          age=age, tier=tier)


def budget_violations(power_series, true_cmat, targets, interval_s: float,
                      rtol: float = 1e-9) -> int:
    """Count (epoch, container) cells whose true gram *rate* exceeds the
    container's target. `power_series` is the recorded (T, N) power
    matrix, `true_cmat` the (T,) or (T, N) TRUE intensity it is billed
    at. The conservative degrade mode must drive this to exactly zero."""
    power = np.asarray(power_series, dtype=np.float64)
    c = np.asarray(true_cmat, dtype=np.float64)
    c2 = c if c.ndim == 2 else c[:, None]
    tg = np.asarray(targets, dtype=np.float64)
    rate = power * c2 / 1000.0
    return int(np.count_nonzero(rate > tg[None, :] * (1.0 + rtol) + 1e-12))
