"""Frozen fault-plan declarations + deterministic mask materializers.

Host numpy, copied from `repro.robustness.faults`. A `FaultPlan` is
materialized into plain NumPy masks keyed only on `(plan.seed,
shape)`, so the same plan gives the same dropouts, gaps and migration
failures on the card, on the CPU and in the reference.

    CarbonFeedFaults(dropout_prob=0.2,
                     blackouts=((-1, 100, 30),),        # all regions
                     noise_windows=((2, 50, 20, 0.3),)) # region 2

Region index ``-1`` means "every region". All windows are
``[start, start + n)`` in epochs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

# independent PCG64 streams per fault class, all derived from the one
# plan seed (salts keep e.g. the dropout pattern stable when a noise
# window is added to the plan)
_SALT_DROPOUT = 0x5EED_01
_SALT_NOISE = 0x5EED_02
_SALT_MIG = 0x5EED_03
_SALT_GAP = 0x5EED_04


@dataclass(frozen=True)
class CarbonFeedFaults:
    """Carbon-intensity feed faults, per (epoch, region) sample.

    dropout_prob   i.i.d. probability a sample is lost
    blackouts      ((region | -1, start, n), ...) windows with no samples
    stale_every    only every k-th epoch delivers a sample (k=1: all)
    noise_windows  ((region | -1, start, n, sigma), ...): delivered
                   samples inside the window are multiplied by
                   exp(sigma * z), z ~ N(0, 1) — the feed reports a
                   wrong-but-plausible value, it does not go missing
    """
    dropout_prob: float = 0.0
    blackouts: Tuple[Tuple[int, int, int], ...] = ()
    stale_every: int = 1
    noise_windows: Tuple[Tuple[int, int, int, float], ...] = ()


@dataclass(frozen=True)
class PowerTelemetryFaults:
    """Power-metering gaps: emissions still physically happen during a
    gap epoch (billing is unchanged) but the metered sample is lost —
    the sweep reports the affected grams as `unmetered_g` so operators
    can see how much of the ledger rests on interpolated power."""
    gap_prob: float = 0.0
    gaps: Tuple[Tuple[int, int], ...] = ()     # ((start, n), ...)


@dataclass(frozen=True)
class MigrationFaults:
    """Actuation-plane faults: each attempted placement migration fails
    i.i.d. with `fail_prob`. A failed attempt pays the full stop-and-copy
    cost (overhead grams + downtime) but the container stays put; the
    planner then backs off `min(backoff_base * 2**(k-1), backoff_cap)`
    epochs after the k-th consecutive failure before retrying."""
    fail_prob: float = 0.0
    backoff_base: int = 1
    backoff_cap: int = 16


@dataclass(frozen=True)
class DegradeConfig:
    """Graceful-degradation ladder for missing carbon samples.

    mode "ladder" (the default) falls through four tiers per (epoch,
    region): fresh sample -> hold-last while `age <= ttl_epochs` ->
    causal diurnal prior (the per-slot running means of
    `repro_torch.carbon.forecast.diurnal_ar1`, fed only with *received*
    samples) while `age <= prior_ttl_epochs` -> conservative `c_max`
    floor. mode "hold" holds the last sample forever (the naive
    baseline whose overshoot is unbounded); mode "conservative" jumps
    straight to `c_max` for any non-fresh epoch, which makes the gram
    budget unconditionally safe (see `observe_intensity`).
    """
    mode: str = "ladder"                 # "ladder" | "hold" | "conservative"
    ttl_epochs: int = 3
    prior_ttl_epochs: int = 288
    c_max: float = 1000.0


@dataclass(frozen=True)
class FaultPlan:
    """One frozen declaration of every signal/actuation-plane fault,
    attached to `SweepSpec.faults`. `seed` drives all stochastic masks."""
    carbon: CarbonFeedFaults = field(default_factory=CarbonFeedFaults)
    power: PowerTelemetryFaults = field(default_factory=PowerTelemetryFaults)
    migration: MigrationFaults = field(default_factory=MigrationFaults)
    degrade: DegradeConfig = field(default_factory=DegradeConfig)
    seed: int = 0


def _window_cols(region: int, R: int):
    return slice(None) if region < 0 else slice(region, region + 1)


def carbon_fault_masks(plan: FaultPlan, T: int, R: int):
    """Materialize the carbon-feed faults as `(fresh (T, R) bool,
    noise_mult (T, R) f64)`. `fresh[t, r]` is True iff a sample arrives
    for region r at epoch t; delivered samples are `true * noise_mult`.
    Deterministic in `(plan.seed, T, R)`."""
    c = plan.carbon
    fresh = np.ones((T, R), dtype=bool)
    if c.stale_every > 1:
        fresh &= (np.arange(T) % int(c.stale_every) == 0)[:, None]
    if c.dropout_prob > 0.0:
        rng = np.random.default_rng(plan.seed + _SALT_DROPOUT)
        fresh &= rng.random((T, R)) >= float(c.dropout_prob)
    for region, start, n in c.blackouts:
        fresh[max(0, start):start + n, _window_cols(region, R)] = False
    noise = np.ones((T, R), dtype=np.float64)
    if c.noise_windows:
        rng = np.random.default_rng(plan.seed + _SALT_NOISE)
        for region, start, n, sigma in c.noise_windows:
            lo, hi = max(0, start), min(T, start + n)
            cols = _window_cols(region, R)
            z = rng.standard_normal((hi - lo, noise[lo:hi, cols].shape[1]))
            noise[lo:hi, cols] *= np.exp(float(sigma) * z)
    return fresh, noise


def migration_failure_mask(plan: Optional[FaultPlan], T: int,
                           N: int) -> Optional[np.ndarray]:
    """(T, N) bool: True where an attempted migration at (epoch, container)
    fails. None when the plan declares no migration faults. Drawn in
    row chunks to keep the transient f64 uniform buffer small at fleet
    scale (PCG64 `random` fills C-order sequentially, so the chunked
    draw is bit-identical to a one-shot (T, N) draw)."""
    if plan is None or plan.migration.fail_prob <= 0.0:
        return None
    p = float(plan.migration.fail_prob)
    rng = np.random.default_rng(plan.seed + _SALT_MIG)
    out = np.empty((T, N), dtype=bool)
    chunk = max(1, 4_000_000 // max(N, 1))
    for lo in range(0, T, chunk):
        hi = min(T, lo + chunk)
        out[lo:hi] = rng.random((hi - lo, N)) < p
    return out


def power_gap_vector(plan: Optional[FaultPlan],
                     T: int) -> Optional[np.ndarray]:
    """(T,) f64 in {0, 1}: 1 where the epoch's power sample is lost.
    None when the plan declares no telemetry gaps."""
    if plan is None:
        return None
    p = plan.power
    if p.gap_prob <= 0.0 and not p.gaps:
        return None
    gap = np.zeros(T, dtype=bool)
    if p.gap_prob > 0.0:
        rng = np.random.default_rng(plan.seed + _SALT_GAP)
        gap |= rng.random(T) < float(p.gap_prob)
    for start, n in p.gaps:
        gap[max(0, start):start + n] = True
    return gap.astype(np.float64)
