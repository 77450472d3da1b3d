"""Straggler mitigation from step-time telemetry (host Python, copied
from `repro.distributed.stragglers`).

A straggling host inflates every synchronous step (the collective waits for
the slowest participant). Detection: robust z-score of recent step times
against the rolling median; mitigation: the Carbon Containers migration
machinery (move the job off the slow slice), which is why the detector
emits the same Action vocabulary as the carbon policy.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional

import numpy as np


@dataclass
class StragglerDetector:
    window: int = 32
    threshold: float = 1.8          # step slower than 1.8x median -> flag
    patience: int = 4               # consecutive flags before acting
    _times: Deque[float] = field(default_factory=deque)
    _flags: int = 0

    def observe(self, step_time_s: float) -> Optional[str]:
        self._times.append(step_time_s)
        if len(self._times) > self.window:
            self._times.popleft()
        if len(self._times) < max(8, self.window // 4):
            return None
        med = float(np.median(self._times))
        if step_time_s > self.threshold * med:
            self._flags += 1
        else:
            self._flags = 0
        if self._flags >= self.patience:
            self._flags = 0
            return "migrate"        # recommend moving off the slow slice
        return None

    def slowdown(self) -> float:
        """Current step time relative to the window median."""
        if len(self._times) < 2:
            return 1.0
        med = float(np.median(self._times))
        return float(self._times[-1]) / max(med, 1e-9)
