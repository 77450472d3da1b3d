"""Step telemetry -> utilization, the per-container monitoring feed (the
reference's `src/repro/power/telemetry.py`; host Python, its own copy).

The job owns its card, so attribution is exact: utilization is the
model-FLOPs utilization of the step timing against the analytic FLOPs
of the step.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque


@dataclass
class StepTelemetry:
    t: float                # wall-clock (or sim-clock) seconds
    step_time_s: float
    tokens: int
    flops: float            # analytic model FLOPs for the step
    duty: float = 1.0


def mfu_utilization(flops: float, step_time_s: float, n_chips: int,
                    peak_flops: float) -> float:
    if step_time_s <= 0:
        return 0.0
    return min(1.0, flops / (step_time_s * n_chips * peak_flops))


class TelemetryWindow:
    """Rolling window of step telemetry, aggregated per monitoring interval."""

    def __init__(self, window_s: float = 300.0):
        self.window_s = window_s
        self.steps: Deque[StepTelemetry] = deque()

    def record(self, t: StepTelemetry):
        self.steps.append(t)
        cutoff = t.t - self.window_s
        while self.steps and self.steps[0].t < cutoff:
            self.steps.popleft()

    def utilization(self, n_chips: int, peak_flops: float) -> float:
        if not self.steps:
            return 0.0
        span = max(self.steps[-1].t - self.steps[0].t
                   + self.steps[-1].step_time_s, 1e-9)
        total_flops = sum(s.flops for s in self.steps)
        return min(1.0, total_flops / (span * n_chips * peak_flops))

    def throughput_tokens_s(self) -> float:
        if not self.steps:
            return 0.0
        span = max(self.steps[-1].t - self.steps[0].t
                   + self.steps[-1].step_time_s, 1e-9)
        return sum(s.tokens for s in self.steps) / span
