"""CarbonAwareTrainer: live Carbon Containers enforcement on a PyTorch
training job (the reference's `src/repro/core/carbon_aware_trainer.py`).

Wraps an `ElasticJob` the way lxcc wraps lxc (paper §3.1.1): beyond the
carbon target, ε, and policy variant, training code is untouched. Each
monitoring interval the trainer:

  1. aggregates step telemetry -> MFU utilization -> power (linear model)
     -> C(t) = p(t)·c(t),
  2. asks the enforcement policy for an action,
  3. applies it: duty-cycling the step loop (vertical scaling),
     checkpoint and restore onto another slice's devices (migration), or
     checkpoint + idle (suspend/resume).

A virtual clock (sim_seconds_per_step) exercises hours of carbon-
intensity variation in seconds; with the default wall clock it runs in
real time. The decisions are host Python, expression for expression the
reference's, on the port's own policy, plant model, slices and carbon
providers.

`slice_device_lists` names each slice's devices: with a process group
(one process a device) the first min(chips, world) ranks, real device
subsets that a migration reshards the job across; without one, the one
device for every slice, as virtual slices. With more than one process
every process runs the trainer, and rank 0's clock and decisions are
broadcast to the others each step, so all take the same actions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import torch.distributed as dist

from repro_torch.carbon.intensity import CarbonIntensityProvider
from repro_torch.cluster.slices import SliceFamily
from repro_torch.config import CarbonConfig
from repro_torch.core.container import ContainerState, PlantModel
from repro_torch.core.elastic import ElasticJob, agree
from repro_torch.core.policy import Action, CarbonContainerPolicy
from repro_torch.power.telemetry import StepTelemetry, TelemetryWindow

# Dense bf16 tensor-core peak of the card this port targets: NVIDIA H100
# SXM, 989 TFLOP/s at its full power limit (NVIDIA's data sheet), on a
# card that `nvidia-smi --query-gpu=name,power.limit` reports as
# "NVIDIA H100 80GB HBM3, 700.00 W".
H100_BF16_PEAK_FLOPS = 989e12


def slice_device_lists(family: SliceFamily, device="cuda") -> list:
    """The devices of each slice: with a process group, ranks
    0..min(chips, world) - 1 (at least one); without one, [`device`]."""
    if not dist.is_initialized():
        return [[device] for _ in range(len(family))]
    world = dist.get_world_size()
    return [list(range(max(1, min(family[i].chips, world))))
            for i in range(len(family))]


@dataclass
class IntervalLog:
    t: float
    carbon_intensity: float
    util: float
    power_w: float
    carbon_rate: float
    slice_name: str
    duty: float
    suspended: bool
    action: str


@dataclass
class CarbonAwareTrainer:
    job: ElasticJob
    family: SliceFamily
    slice_devices: Sequence[Sequence]        # devices per family slice
    carbon: CarbonIntensityProvider
    cfg: CarbonConfig
    step_flops: float                        # analytic FLOPs per train step
    step_tokens: int
    peak_flops_per_chip: float = H100_BF16_PEAK_FLOPS
    sim_seconds_per_step: float = 0.0        # 0 -> wall clock
    policy: Optional[CarbonContainerPolicy] = None
    logs: list = field(default_factory=list)

    def __post_init__(self):
        if self.policy is None:
            self.policy = CarbonContainerPolicy(variant=self.cfg.policy)
        self.state = ContainerState(slice_idx=self.family.baseline_idx)
        self.telemetry = TelemetryWindow(window_s=self.cfg.interval_s)
        self._t = 0.0
        self._last_decision_t = -1e18

    # ------------------------------------------------------------------
    def _now(self) -> float:
        return self._t

    def _advance(self, dt: float):
        self._t += dt

    def _chips(self) -> int:
        s = self.family[self.state.slice_idx]
        return max(s.chips, 1)

    def _demand_estimate(self) -> float:
        """Workload intensity in baseline-slice units from telemetry."""
        util = self.telemetry.utilization(self._chips(),
                                          self.peak_flops_per_chip)
        s = self.family[self.state.slice_idx]
        # throttled at the duty quota means demand >= what we observe
        d = util * s.multiple
        if self.state.duty < 1.0 and util >= 0.95 * self.state.duty:
            d = max(d, s.multiple)       # optimistic doubling rule (§3.1.2)
        return d

    # ------------------------------------------------------------------
    def run(self, data_iter, n_steps: int,
            on_interval: Optional[Callable] = None) -> dict:
        it = iter(data_iter)
        steps_done = 0
        while steps_done < n_steps:
            if self.state.suspended:
                self._advance(self.cfg.interval_s)
                self._maybe_enforce(force=True)
                continue
            t_wall = time.perf_counter()
            metrics = self.job.train_step(next(it))   # synced: floats
            wall_dt = time.perf_counter() - t_wall
            step_dt = agree(self.sim_seconds_per_step or wall_dt)
            # vertical scaling: duty-cycle the step loop
            idle_dt = step_dt * (1.0 / max(self.state.duty, 1e-3) - 1.0) \
                if self.state.duty < 1.0 else 0.0
            self._advance(step_dt + idle_dt)
            self.telemetry.record(StepTelemetry(
                t=self._now(), step_time_s=step_dt + idle_dt,
                tokens=self.step_tokens, flops=self.step_flops,
                duty=self.state.duty))
            steps_done += 1
            self._maybe_enforce()
            if on_interval and self.logs:
                on_interval(self.logs[-1], metrics)
        return {"steps": steps_done, "logs": self.logs,
                "migrations": self.job.migrations}

    # ------------------------------------------------------------------
    def _maybe_enforce(self, force: bool = False):
        if not force and (self._now() - self._last_decision_t
                          < self.cfg.interval_s):
            return
        self._last_decision_t = self._now()
        c = self.carbon.intensity(self._now())
        demand = self._demand_estimate()
        self.state.observe_demand(demand)
        action: Action = agree(self.policy.decide(
            self.family, self.state, demand, c,
            self.cfg.target_rate, self.cfg.epsilon))
        self._apply(action, c, demand)

    def _apply(self, action: Action, c: float, demand: float):
        st = self.state
        if action.kind == "suspend":
            if not st.suspended:
                self.job.suspend()
            st.suspended = True
        elif action.kind == "resume":
            if st.suspended:
                st.slice_idx = action.target_slice or st.slice_idx
                self.job.resume(self.slice_devices[st.slice_idx])
            st.suspended = False
            st.duty = max(action.duty, 0.05)
        elif action.kind == "migrate":
            st.dwell = 0
            st.slice_idx = action.target_slice
            st.duty = max(action.duty, 0.05)
            self.job.migrate(self.slice_devices[st.slice_idx])
        else:
            st.duty = max(action.duty, 0.05)
        st.dwell += 1
        s = self.family[st.slice_idx]
        util = min(demand / s.multiple, st.duty) if not st.suspended else 0.0
        power = 0.0 if st.suspended else s.power.power(util)
        self.logs.append(IntervalLog(
            t=self._now(), carbon_intensity=c, util=util, power_w=power,
            carbon_rate=PlantModel.rate(power, c), slice_name=s.name,
            duty=st.duty, suspended=st.suspended, action=action.kind))
