"""Replica autoscaling under a carbon cap (CarbonScaler-style greedy).

Host numpy, copied from `repro.traffic.autoscale` (the vectorized
autoscaler). Each epoch, routed load per region is converted to a
replica count:

  - `need = ceil(load / cap1)` replicas would serve everything
    (`cap1 = throughput_rps * interval_s` requests per replica-epoch);
  - ramp limits (`max_step`) and floors/ceilings (`min_replicas`,
    `max_replicas`) bound the reachable range `[lo, hi]` around the
    previous count; replicas up to `lo` are *mandatory*;
  - with a `budget_g_per_epoch` carbon cap, the *optional* replicas
    (`lo < k <= desired`) across all regions compete by marginal
    carbon-efficiency w/g: the greedy flattens the (R, K) table, sorts
    by efficiency descending (stable) and admits down the list while
    the running `cumsum` of grams fits under the cap. Zero-gram entries
    (carbon intensity 0) are free and sort first.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class ReplicaConfig:
    """Per-region replica fleet spec (homogeneous replicas)."""
    throughput_rps: float = 100.0     # requests/s one replica serves
    base_w: float = 60.0              # idle power per replica
    peak_w: float = 120.0             # full-utilization power per replica
    max_replicas: int = 64            # per-region ceiling (K of the table)
    min_replicas: int = 1             # per-region floor (always running)
    max_step: int = 8                 # max replica delta per epoch
    budget_g_per_epoch: Optional[float] = None   # fleet-wide carbon cap

    def __post_init__(self):
        if self.min_replicas > self.max_replicas:
            raise ValueError("min_replicas exceeds max_replicas")
        if self.max_step < 0 or self.max_replicas < 1:
            raise ValueError("max_step must be >= 0, max_replicas >= 1")
        if self.throughput_rps <= 0:
            raise ValueError("throughput_rps must be positive")

    def cap1(self, interval_s: float) -> float:
        """Requests one replica serves in one epoch."""
        return self.throughput_rps * interval_s

    def max_capacity(self, interval_s: float) -> float:
        """Requests-per-epoch ceiling of a fully scaled region."""
        return self.max_replicas * self.cap1(interval_s)


@dataclass
class AutoscaleResult:
    replicas: np.ndarray      # (T, R) int64 replica counts
    served: np.ndarray        # (T, R) requests served
    dropped: np.ndarray       # (T, R) routed load beyond replica capacity
    emissions_g: np.ndarray   # (T, R) replica-fleet emissions
    cap1: float               # requests per replica-epoch

    @property
    def replica_epochs(self) -> float:
        return float(self.replicas.sum())


def autoscale(routed, carbon, cfg: ReplicaConfig,
              interval_s: float = 300.0) -> AutoscaleResult:
    """Vectorized autoscaler: one (R, K) marginal table per epoch."""
    routed = np.asarray(routed, dtype=np.float64)
    carbon = np.asarray(carbon, dtype=np.float64)
    if routed.shape != carbon.shape or routed.ndim != 2:
        raise ValueError(f"routed {routed.shape} / carbon {carbon.shape} "
                         f"must both be (T, R)")
    T, R = routed.shape
    dt = float(interval_s)
    cap1 = cfg.cap1(dt)
    span = cfg.peak_w - cfg.base_w
    K = cfg.max_replicas
    k_idx = np.arange(1, K + 1, dtype=np.float64)[None, :]   # (1, K)
    reg_of = np.repeat(np.arange(R), K)                      # flat -> region

    replicas = np.zeros((T, R), dtype=np.int64)
    served = np.zeros((T, R))
    dropped = np.zeros((T, R))
    emissions = np.zeros((T, R))
    prev = np.full(R, float(cfg.min_replicas))
    for t in range(T):
        load = routed[t]
        c = carbon[t]
        need = np.ceil(load / cap1)
        lo = np.maximum(float(cfg.min_replicas), prev - cfg.max_step)
        hi = np.minimum(float(cfg.max_replicas), prev + cfg.max_step)
        desired = np.minimum(np.maximum(need, lo), hi)
        if cfg.budget_g_per_epoch is None:
            n = desired
        else:
            w = np.clip(load[:, None] - (k_idx - 1.0) * cap1, 0.0, cap1)
            g = ((cfg.base_w + span * (w / cap1))
                 * dt / 3600.0 * c[:, None] / 1000.0)
            mand = k_idx <= lo[:, None]
            opt = (k_idx > lo[:, None]) & (k_idx <= desired[:, None])
            mand_flat = np.where(mand, g, 0.0).ravel()
            mand_g = float(np.cumsum(mand_flat)[-1]) if mand_flat.size else 0.0
            # zero-gram entries (carbon intensity 0) are free: admit them
            # first (-inf score) instead of dividing — w/tiny overflows
            free = g <= 0.0
            eff = w / np.where(free, 1.0, g)
            score = np.where(opt, np.where(free, -np.inf, -eff),
                             np.inf).ravel()
            order = np.argsort(score, kind="stable")
            gs = np.where(opt, g, 0.0).ravel()[order]
            cum = np.cumsum(gs)
            admit = (opt.ravel()[order]
                     & (mand_g + cum <= cfg.budget_g_per_epoch))
            counts = np.bincount(reg_of[order[admit]], minlength=R)
            n = lo + counts
        srv = np.minimum(load, n * cap1)
        pw = n * cfg.base_w + span * (srv / cap1)
        replicas[t] = n.astype(np.int64)
        served[t] = srv
        dropped[t] = load - srv
        emissions[t] = pw * dt / 3600.0 * c / 1000.0
        prev = n
    return AutoscaleResult(replicas=replicas, served=served, dropped=dropped,
                           emissions_g=emissions, cap1=cap1)

