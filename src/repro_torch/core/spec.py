"""Declarative sweep surface of the port: `SweepSpec` and `SweepResult`.

The port's counterpart of `repro.core.spec`: one value holds the whole
sweep, `run()` executes it on ``backend="torch"`` on `device`, and the
result wraps the aggregate rows with `keys`, `col` and `parity`.
`parity` reads only ``rows`` and ``keys()`` of the other result, so a
port result compares directly with a reference one.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.cluster.slices import SliceFamily
from repro_torch.core.simulator import SimConfig

# row keys that are per-sweep metadata, not comparable metrics
_NON_METRIC = {"policy", "target", "time_on_slice"}


@dataclass
class SweepSpec:
    """Everything a population sweep needs, as one value.

    `placement` is either a ready `PlacementEngine`, or a
    `PlacementConfig` to pair with `regions` (per-region carbon providers
    or a (T, R) intensity matrix); the engine is then built on
    `sim.interval_s`. `traffic`, `elasticity`, `energy` and `faults` are
    later slices of the port and raise `NotImplementedError` when set.
    """
    policies: dict
    family: SliceFamily
    traces: Sequence
    targets: Sequence[float]
    carbon: object = None               # provider / matrix; None when
    #                                     placement supplies it
    sim: SimConfig = field(
        default_factory=lambda: SimConfig(target_rate=0.0))
    demand_scale: float = 1.0
    backend: str = "torch"
    placement: object = None            # PlacementEngine | PlacementConfig
    regions: object = None              # with a PlacementConfig placement
    region_names: Optional[Sequence[str]] = None
    traffic: object = None
    elasticity: object = None
    energy: object = None
    faults: object = None
    device: str = "cuda"

    def resolve_placement(self):
        """The placement engine (building one from a config), or None."""
        if self.placement is None:
            if self.regions is not None:
                raise ValueError("SweepSpec.regions without a placement "
                                 "config; set placement=PlacementConfig(...)")
            return None
        from repro_torch.cluster.placement import (PlacementConfig,
                                                   PlacementEngine)
        if not isinstance(self.placement, PlacementConfig):
            if self.regions is not None:
                raise ValueError("pass either a PlacementEngine or a "
                                 "(PlacementConfig, regions) pair, not both")
            return self.placement
        if self.regions is None:
            raise ValueError("placement=PlacementConfig(...) needs "
                             "SweepSpec.regions (per-region carbon "
                             "providers or a (T, R) intensity matrix)")
        return PlacementEngine(self.family, self.regions,
                               interval_s=self.sim.interval_s,
                               config=self.placement,
                               region_names=self.region_names)

    def run(self) -> "SweepResult":
        """Execute the sweep on the torch backend, on `device`."""
        if self.backend != "torch":
            raise ValueError(f"the port runs backend='torch', got "
                             f"{self.backend!r}")
        from repro_torch.core.fleet import sweep_population_torch
        rows = sweep_population_torch(
            self.policies, self.family, self.traces, self.carbon,
            self.targets, self.sim, demand_scale=self.demand_scale,
            placement=self.resolve_placement(), traffic=self.traffic,
            elasticity=self.elasticity, energy=self.energy,
            faults=self.faults, device=self.device)
        return SweepResult(rows=rows, backend=self.backend)


@dataclass
class SweepResult:
    """The per-(target, policy) aggregate rows of a sweep behind one
    shape."""
    rows: list
    backend: str

    def __len__(self):
        return len(self.rows)

    def keys(self) -> list:
        """Numeric metric keys present in every row (sorted)."""
        common = set.intersection(*(set(r) for r in self.rows))
        return sorted(k for k in common - _NON_METRIC
                      if isinstance(self.rows[0][k], (int, float, bool)))

    def col(self, key: str) -> np.ndarray:
        """One metric across the rows, in row order."""
        return np.asarray([float(r[key]) for r in self.rows])

    def parity(self, other, keys=None) -> float:
        """Max relative difference vs another run of the same sweep (rows
        matched by order; keys default to the shared numeric metrics)."""
        if len(other.rows) != len(self.rows):
            raise ValueError(f"row count mismatch: {len(self.rows)} vs "
                             f"{len(other.rows)}")
        if keys is None:
            keys = sorted(set(self.keys()) & set(other.keys()))
        worst = 0.0
        for a, b in zip(self.rows, other.rows):
            for k in keys:
                num = abs(float(a[k]) - float(b[k]))
                worst = max(worst, num / max(abs(float(a[k])), 1.0))
        return worst
