"""Carbon Container state + plant model (host Python, copied from
`repro.core.container`).

``PlantModel`` is the physics the scalar simulator and the carbon-aware
serving loop share: given a slice, a duty-cycle quota, workload demand
(in baseline-capacity units) and grid carbon intensity, it yields served
work, power, and the carbon emissions rate C(t) = p(t)·c(t) (paper
§3.1.2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.cluster.slices import Slice, SliceFamily


@dataclass
class Step:
    """One monitoring-interval outcome."""
    served: float            # work served, baseline-capacity units
    throttled: float         # unmet demand, baseline-capacity units
    power_w: float
    carbon_rate: float       # g CO2e / hr
    util: float              # utilization of the current slice


class PlantModel:
    """Work/power/carbon response of a container on a slice."""

    @staticmethod
    def run(s: Slice, duty: float, demand: float, c_intensity: float) -> Step:
        cap = s.multiple * max(0.0, min(duty, 1.0))
        served = min(demand, cap)
        util = served / s.multiple if s.multiple > 0 else 0.0
        power = s.power.power(util)
        return Step(served=served, throttled=max(0.0, demand - served),
                    power_w=power, carbon_rate=power * c_intensity / 1000.0,
                    util=util)

    @staticmethod
    def idle_power(s: Slice) -> float:
        return s.power.base_w

    @staticmethod
    def rate(power_w: float, c_intensity: float) -> float:
        return power_w * c_intensity / 1000.0


@dataclass
class ContainerState:
    slice_idx: int
    duty: float = 1.0
    suspended: bool = False
    migrating_s: float = 0.0            # remaining migration downtime
    migrate_target: Optional[int] = None
    dwell: int = 0                      # intervals since last migration
    # accounting
    emissions_g: float = 0.0
    energy_wh: float = 0.0
    work_done: float = 0.0
    time_on_slice_s: dict = field(default_factory=dict)
    migrations: int = 0
    suspended_s: float = 0.0
    throttled_integral: float = 0.0     # ∫ (demand-served) dt, baseline units·s
    demand_integral: float = 0.0
    elapsed_s: float = 0.0
    demand_window: list = field(default_factory=list)   # last N intervals

    def observe_demand(self, d: float, n: int = 6):
        self.demand_window.append(d)
        if len(self.demand_window) > n:
            self.demand_window.pop(0)

    @property
    def recent_peak(self) -> float:
        return max(self.demand_window) if self.demand_window else 0.0


@dataclass
class CarbonContainer:
    """The lxcc-facing object: a registered container with a carbon target.

    Mirrors the paper's interface: a target rate, an ε threshold, a policy
    variant, and transparent enforcement — the wrapped application only
    supplies workload demand (or real step telemetry via the trainer).
    """
    family: SliceFamily
    target_rate: float                  # C_target, g/hr
    epsilon: float = 0.05
    policy: object = None               # set by factory
    state: ContainerState = None

    def __post_init__(self):
        if self.state is None:
            self.state = ContainerState(slice_idx=self.family.baseline_idx)

    def set_target(self, rate: float):
        self.target_rate = rate

    @property
    def current_slice(self) -> Slice:
        return self.family[self.state.slice_idx]
