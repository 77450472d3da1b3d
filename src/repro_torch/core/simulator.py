"""Simulation settings shared by the sweep entry points (the port's copy
of `repro.core.simulator.SimConfig`)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SimConfig:
    target_rate: float                  # g CO2e/hr
    epsilon: float = 0.05
    interval_s: float = 300.0
    state_gb: float = 1.0               # migrated state footprint (Fig. 7)
    suspend_releases_slice: bool = True  # cloud-user view: release = no power
