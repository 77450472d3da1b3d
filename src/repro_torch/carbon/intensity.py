"""Carbon-intensity providers (host numpy, copied from
`repro.carbon.intensity`).

Providers expose ``intensity(t_seconds)`` (the scalar controller's
lookup) and ``intensity_series(t_seconds)`` (the fleet's) in
g·CO₂e/kWh, piecewise constant per hour (paper §3.1.2).
"""
from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np

from repro_torch.carbon.traces import fill_gaps, synth_trace


class CarbonIntensityProvider(Protocol):
    def intensity(self, t_seconds: float) -> float: ...


class ConstantProvider:
    def __init__(self, value: float):
        self.value = float(value)

    def intensity(self, t_seconds: float) -> float:
        return self.value

    def intensity_series(self, t_seconds: np.ndarray) -> np.ndarray:
        return np.full(np.shape(t_seconds), self.value, dtype=np.float64)


class TraceProvider:
    """Hourly trace, piecewise constant, wraps around at the end.
    `gap_policy` is as in `fill_gaps`."""

    def __init__(self, hourly: Sequence[float], start_s: float = 0.0,
                 gap_policy: str = "raise"):
        self.hourly = np.asarray(hourly, dtype=np.float64)
        self.start_s = start_s
        if len(self.hourly) == 0:
            raise ValueError("empty carbon trace")
        self.hourly = fill_gaps(self.hourly, gap_policy)

    @classmethod
    def for_region(cls, region: str, hours: int = 24 * 30, seed: int = 0):
        return cls(synth_trace(region, hours, seed))

    def intensity(self, t_seconds: float) -> float:
        idx = int((t_seconds - self.start_s) // 3600.0) % len(self.hourly)
        return float(self.hourly[idx])

    def intensity_series(self, t_seconds: np.ndarray) -> np.ndarray:
        t = np.asarray(t_seconds, dtype=np.float64)
        idx = ((t - self.start_s) // 3600.0).astype(np.int64) % len(self.hourly)
        return self.hourly[idx]
