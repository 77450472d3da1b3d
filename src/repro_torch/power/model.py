"""Linear power model (paper §3.1.2 / Fig. 6), copied from
`repro.power.model`: P(util) = P_base + (P_peak − P_base) · util."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LinearPowerModel:
    base_w: float
    peak_w: float

    def scale(self, m: float) -> "LinearPowerModel":
        """Proportional family member (paper §5.1.2: power ∝ capacity)."""
        return LinearPowerModel(self.base_w * m, self.peak_w * m)
