"""Per-region request-arrival generation for synthetic user populations.

Host numpy, copied from `repro.traffic.arrivals`. A `UserPopulation`
maps users -> home region -> diurnal phase; each region's aggregate
request stream is the per-user total shaped by a time-zone-shifted
diurnal sinusoid (peak at 15:00 local time) and the AR(1)+burst noise
of `repro_torch.workload.azure_like.ar1_burst_factors`. Only the
(T, R) aggregate materializes: per-user draws are summed in chunks, so
`n_users=10**6` costs O(chunk) scratch. The draw order is part of the
contract: the same seed gives the same tensor on both sides.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.workload.azure_like import ar1_burst_factors

_PEAK_HOUR_LOCAL = 15.0      # diurnal peak at 15:00 local time


@dataclass(frozen=True)
class UserPopulation:
    """Spec for a synthetic user population spread over R regions."""
    n_users: int = 1_000_000
    n_regions: int = 3
    region_weights: Optional[tuple] = None   # default: uniform
    tz_offset_h: Optional[tuple] = None      # default: evenly spread over 24h
    req_per_user_day: float = 50.0
    rate_lognorm_sigma: float = 1.0          # per-user rate spread (log space)
    peak_to_trough: float = 3.0              # diurnal peak/trough ratio
    cov: float = 0.25                        # AR(1)+burst noise volatility
    normalize: bool = True                   # pin per-region totals exactly
    seed: int = 0

    def weights(self) -> np.ndarray:
        if self.region_weights is None:
            return np.full(self.n_regions, 1.0 / self.n_regions)
        w = np.asarray(self.region_weights, dtype=np.float64)
        if w.shape != (self.n_regions,) or w.min() < 0 or w.sum() <= 0:
            raise ValueError(f"region_weights {self.region_weights!r} "
                             f"invalid for n_regions={self.n_regions}")
        return w / w.sum()

    def tz_offsets(self) -> np.ndarray:
        if self.tz_offset_h is None:
            return np.arange(self.n_regions) * (24.0 / self.n_regions)
        tz = np.asarray(self.tz_offset_h, dtype=np.float64)
        if tz.shape != (self.n_regions,):
            raise ValueError(f"tz_offset_h needs {self.n_regions} entries")
        return tz

    def user_counts(self) -> np.ndarray:
        """Largest-remainder split of n_users over the region weights."""
        quota = self.weights() * self.n_users
        counts = np.floor(quota).astype(np.int64)
        short = self.n_users - int(counts.sum())
        if short:
            order = np.argsort(-(quota - counts), kind="stable")
            counts[order[:short]] += 1
        return counts


@dataclass
class ArrivalTensor:
    """(T, R) requests-per-epoch plus the population facts behind it."""
    requests: np.ndarray         # (T, R) requests arriving per epoch
    users: np.ndarray            # (R,) user counts
    tz_offset_h: np.ndarray      # (R,)
    req_per_day: np.ndarray      # (R,) aggregate daily request totals
    interval_s: float

    @property
    def n_users(self) -> int:
        return int(self.users.sum())

    @property
    def offered_total(self) -> float:
        return float(self.requests.sum())


def _diurnal_shape(T: int, interval_s: float, tz: np.ndarray,
                   peak_to_trough: float) -> np.ndarray:
    """(T, R) mean-1 sinusoid peaking at 15:00 local time per region."""
    amp = (peak_to_trough - 1.0) / (peak_to_trough + 1.0)
    hours = np.arange(T, dtype=np.float64) * interval_s / 3600.0
    local = hours[:, None] + tz[None, :]
    phase = 2.0 * np.pi * (local - _PEAK_HOUR_LOCAL) / 24.0
    return np.maximum(1.0 + amp * np.cos(phase), 0.05)


def request_matrix(pop: UserPopulation, T: int, interval_s: float = 300.0,
                   chunk: int = 200_000) -> ArrivalTensor:
    """Aggregate the population's request streams to (T, R) per-epoch
    counts. Per-user mean rates are lognormal with the -sigma^2/2
    correction (population mean stays `req_per_user_day`), summed in
    `chunk`-sized blocks; with `normalize` each region's noisy shape is
    rescaled to mean 1 so the horizon total is exactly
    `users[r] * req_per_user_day * days`."""
    rng = np.random.default_rng(pop.seed)
    users = pop.user_counts()
    R = pop.n_regions
    sig = pop.rate_lognorm_sigma
    mu = np.log(max(pop.req_per_user_day, 1e-12)) - 0.5 * sig ** 2
    req_day = np.zeros(R)
    for r in range(R):
        remaining = int(users[r])
        while remaining > 0:
            k = min(chunk, remaining)
            req_day[r] += float(np.exp(rng.normal(mu, sig, k)).sum())
            remaining -= k

    tz = pop.tz_offsets()
    shape = _diurnal_shape(T, interval_s, tz, pop.peak_to_trough)
    noise = ar1_burst_factors(rng, T, np.full(R, max(pop.cov, 0.02)))
    factors = shape * noise
    if pop.normalize:
        factors = factors / np.maximum(factors.mean(axis=0), 1e-12)
    requests = req_day[None, :] * (interval_s / 86400.0) * factors
    return ArrivalTensor(requests=requests, users=users, tz_offset_h=tz,
                         req_per_day=req_day, interval_s=float(interval_s))
