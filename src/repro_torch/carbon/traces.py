"""Synthetic hourly carbon-intensity traces calibrated to region statistics.

c(t) = avg · max(floor, 1 + a·sin-diurnal(t-φ) + AR(1) noise)

Host numpy, copied from `repro.carbon.traces`: the same seed gives the
same trace on both sides, so the port and the reference see identical
carbon inputs.
"""
from __future__ import annotations

import zlib

import numpy as np

from repro_torch.carbon.regions import REGIONS, RegionStats


def synth_trace(region: str | RegionStats, hours: int = 24 * 30,
                seed: int = 0) -> np.ndarray:
    """Hourly g·CO₂e/kWh array of length `hours`."""
    r = REGIONS[region] if isinstance(region, str) else region
    # stable per-region salt (str hash() is salted per process)
    rng = np.random.default_rng(seed + (zlib.crc32(r.name.encode()) % 100003))
    t = np.arange(hours, dtype=np.float64)
    # split target variance: 2/3 diurnal, 1/3 AR noise
    a = np.sqrt(2.0 * (r.cov ** 2) * 2.0 / 3.0)
    sigma = np.sqrt((r.cov ** 2) / 3.0)
    diurnal = -a * np.sin(2 * np.pi * (t - r.diurnal_phase_h + 6.0) / 24.0)
    rho = 0.9
    eps = rng.normal(0, sigma * np.sqrt(1 - rho ** 2), hours)
    ar = np.zeros(hours)
    for i in range(1, hours):
        ar[i] = rho * ar[i - 1] + eps[i]
    return r.avg * np.maximum(0.05, 1.0 + diurnal + ar)


def trace_cov(series: np.ndarray) -> float:
    return float(np.std(series) / np.mean(series))


def fill_gaps(series, gap_policy: str = "raise") -> np.ndarray:
    """Guard a carbon trace against NaN gaps (missing API samples):
    "raise" rejects them, "interpolate" fills interior gaps linearly and
    holds the nearest real sample at the edges, "hold" forward-fills
    (leading gaps take the first real sample)."""
    s = np.asarray(series, dtype=np.float64)
    nan = np.isnan(s)
    if not nan.any():
        return s
    if gap_policy == "raise":
        where = np.flatnonzero(nan)
        head = ", ".join(str(i) for i in where[:8])
        more = f" (+{where.size - 8} more)" if where.size > 8 else ""
        raise ValueError(f"carbon trace has {where.size} NaN gap(s) at "
                         f"indices [{head}]{more}; pass "
                         f"gap_policy='interpolate' or 'hold' to fill")
    if nan.all():
        raise ValueError("carbon trace is all-NaN; nothing to fill from")
    idx = np.arange(s.size, dtype=np.float64)
    good = ~nan
    if gap_policy == "interpolate":
        return np.interp(idx, idx[good], s[good])
    if gap_policy == "hold":
        last = np.maximum.accumulate(np.where(good, np.arange(s.size), -1))
        first = int(np.flatnonzero(good)[0])
        return s[np.where(last >= 0, last, first)]
    raise ValueError(f"unknown gap_policy {gap_policy!r}; expected "
                     f"'raise', 'interpolate' or 'hold'")
