"""Carbon enforcement policies (paper §3.2) as parameter holders.

The fleet scan (`repro_torch.core.fleet`) holds the decision kernels;
these classes only carry the parameters the kernels read. Their fields
and defaults match `repro.core.policy`.
"""
from __future__ import annotations

from dataclasses import dataclass

# integer action codes of the decision kernels
K_STAY, K_MIGRATE, K_SUSPEND, K_RESUME = 0, 1, 2, 3


@dataclass
class CarbonContainerPolicy:
    """The Carbon Containers policy: vertical scaling, migration and
    suspend/resume against a g·CO₂e/h budget, in the energy-efficiency
    (§3.2.2) or performance (§3.2.3) variant."""
    variant: str = "energy"          # energy | performance
    allow_migration: bool = True
    min_dwell: int = 2               # intervals between migrations (anti-thrash)
    idle_margin: float = 0.02        # EE idle-migration power improvement margin


@dataclass
class CarbonAgnosticPolicy:
    """Baseline server, no scaling, no migration, never suspends."""


@dataclass
class SuspendResumePolicy:
    """Wait-AWhile-style: baseline server; suspend when emissions at the
    current demand would exceed the target, resume when they fit."""


def VScaleOnlyPolicy(variant: str = "energy") -> CarbonContainerPolicy:
    """Carbon Containers without migration (vertical scaling + suspend)."""
    return CarbonContainerPolicy(variant=variant, allow_migration=False)
