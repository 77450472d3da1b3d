"""Trace replay harness (the stress-ng role from the paper's §4.1), copied
from `repro.workload.replay`.

Replays a utilization trace against any driver exposing
``apply_load(util) -> achieved_util``, and verifies tracking accuracy the
way the paper's Fig. 9 does (moving average within tolerance of target).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np


@dataclass
class ReplayHarness:
    interval_s: float = 300.0
    tolerance: float = 0.05       # moving-average tracking bound (Fig. 9)
    history: list = field(default_factory=list)

    def replay(self, trace: Sequence[float],
               apply_load: Callable[[float], float]) -> dict:
        achieved = []
        for u in trace:
            achieved.append(float(apply_load(float(u))))
        self.history.extend(achieved)
        if not achieved:
            # an empty trace tracks trivially (and the moving-average
            # kernel below would be 0-length)
            return {"mean_abs_err": 0.0, "ma_max_err": 0.0,
                    "within_tolerance": True, "achieved": achieved}
        tr = np.asarray(trace, dtype=np.float64)
        ac = np.asarray(achieved, dtype=np.float64)
        # moving average over 12 intervals (1 h at 5-min readings)
        k = min(12, len(ac))
        kern = np.ones(k) / k
        ma = np.convolve(ac, kern, mode="valid")
        ma_t = np.convolve(tr, kern, mode="valid")
        ma_max_err = float(np.max(np.abs(ma - ma_t))) if len(ma) else 0.0
        return {
            "mean_abs_err": float(np.mean(np.abs(ac - tr))),
            "ma_max_err": ma_max_err,
            "within_tolerance": ma_max_err <= self.tolerance,
            "achieved": achieved,
        }
