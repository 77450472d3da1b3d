"""Power models (paper §3.1.2 / Fig. 6), copied from `repro.power.model`.

The paper validates a *linear* model on real servers: base power at idle
plus a marginal component tracking utilization,

    P(util) = P_base + (P_peak − P_base) · util

with memory, disk and network adding little dynamic range (its Fig. 6).
``calibrate_linear`` reproduces the paper's calibration workflow: fit
(base, peak) from (utilization, watts) samples by least squares.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class LinearPowerModel:
    base_w: float
    peak_w: float

    def power(self, util: float) -> float:
        u = min(max(util, 0.0), 1.0)
        return self.base_w + (self.peak_w - self.base_w) * u

    def util_for_power(self, watts: float) -> float:
        """Inverse model: utilization quota that caps power at `watts`."""
        if watts <= self.base_w:
            return 0.0
        if self.peak_w <= self.base_w:
            return 1.0
        return min(1.0, (watts - self.base_w) / (self.peak_w - self.base_w))

    def scale(self, m: float) -> "LinearPowerModel":
        """Proportional family member (paper §5.1.2: power ∝ capacity)."""
        return LinearPowerModel(self.base_w * m, self.peak_w * m)


def calibrate_linear(utils: Sequence[float], watts: Sequence[float]) -> tuple:
    """Least-squares (base, peak) + R² from measurements (paper Fig. 6)."""
    u = np.asarray(utils, dtype=np.float64)
    w = np.asarray(watts, dtype=np.float64)
    A = np.stack([np.ones_like(u), u], axis=1)
    coef, *_ = np.linalg.lstsq(A, w, rcond=None)
    base, slope = float(coef[0]), float(coef[1])
    pred = A @ coef
    ss_res = float(np.sum((w - pred) ** 2))
    ss_tot = float(np.sum((w - np.mean(w)) ** 2))
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    return LinearPowerModel(base, base + slope), r2


def component_power_sweep(model: LinearPowerModel, seed: int = 0) -> dict:
    """Measured-power-vs-utilization per component, Fig.-6-shaped: the CPU
    holds the dynamic range; memory, disk and network add little (each
    measured with the CPU pinned at 100 %, as in the paper)."""
    rng = np.random.default_rng(seed)
    utils = np.linspace(0, 1, 11)
    spread = model.peak_w - model.base_w
    out = {"util": utils.tolist()}
    out["cpu"] = (model.base_w + spread * utils
                  + rng.normal(0, 0.01 * spread, 11)).tolist()
    for comp, frac in (("memory", 0.05), ("disk", 0.03), ("network", 0.02)):
        out[comp] = (model.peak_w + frac * spread * utils
                     + rng.normal(0, 0.01 * spread, 11)).tolist()
    return out
