"""Slice (server) families: homogeneous capacities at fixed multiples.

Copied from `repro.cluster.slices`. ``paper_family`` is the paper's
0.25×…4× family (§5.1.2: baseline 100 W base, 200 W peak);
``tpu_v5e_family`` maps slices of 16…256 chips. `FamilyTables.to`
moves the per-slice tables onto a device for the fleet scan.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.power.model import LinearPowerModel


@dataclass(frozen=True)
class Slice:
    name: str
    multiple: float            # capacity relative to the baseline slice
    power: LinearPowerModel
    chips: int = 0             # 0 for the paper's abstract servers
    state_bw_gbps: float = 1.0  # checkpoint/migration path bandwidth (GB/s)

    def capacity(self) -> float:
        return self.multiple


class SliceFamily:
    """Ordered catalog (smallest -> largest) with availability tracking."""

    def __init__(self, slices: Sequence[Slice], baseline_idx: int):
        self.slices = sorted(slices, key=lambda s: s.multiple)
        base_mult = sorted(slices, key=lambda x: x.multiple)[baseline_idx].multiple
        self.baseline_idx = next(i for i, s in enumerate(self.slices)
                                 if s.multiple == base_mult)
        self.available = [True] * len(self.slices)

    def __len__(self):
        return len(self.slices)

    def __getitem__(self, i: int) -> Slice:
        return self.slices[i]

    @property
    def baseline(self) -> Slice:
        return self.slices[self.baseline_idx]

    def next_smaller(self, i: int) -> Optional[int]:
        for j in range(i - 1, -1, -1):
            if self.available[j]:
                return j
        return None

    def next_larger(self, i: int) -> Optional[int]:
        for j in range(i + 1, len(self.slices)):
            if self.available[j]:
                return j
        return None

    def smallest(self) -> int:
        return next(i for i, a in enumerate(self.available) if a)

    def tables(self) -> "FamilyTables":
        """Snapshot the family as flat per-slice arrays (-1 = no
        neighbour); later `available` changes do not propagate."""
        n = len(self.slices)
        ns = np.array([(-1 if (j := self.next_smaller(i)) is None else j)
                       for i in range(n)], dtype=np.int64)
        nl = np.array([(-1 if (j := self.next_larger(i)) is None else j)
                       for i in range(n)], dtype=np.int64)
        return FamilyTables(
            base_w=np.array([s.power.base_w for s in self.slices]),
            peak_w=np.array([s.power.peak_w for s in self.slices]),
            multiple=np.array([s.multiple for s in self.slices]),
            bw_gbps=np.array([s.state_bw_gbps for s in self.slices]),
            next_smaller=ns,
            next_larger=nl,
            smallest=self.smallest(),
            baseline_idx=self.baseline_idx,
            names=tuple(s.name for s in self.slices),
            well_formed=bool(all(s.power.peak_w > s.power.base_w
                                 for s in self.slices)),
        )


class SliceTensors(NamedTuple):
    """The per-slice tables of a `FamilyTables` on one device."""
    base_w: torch.Tensor          # (S,) f64
    peak_w: torch.Tensor          # (S,) f64
    multiple: torch.Tensor        # (S,) f64
    bw_gbps: torch.Tensor         # (S,) f64
    next_smaller: torch.Tensor    # (S,) int64, -1 = none
    next_larger: torch.Tensor     # (S,) int64, -1 = none


@dataclass(frozen=True)
class FamilyTables:
    """Flat-array view of a SliceFamily, indexed by slice position
    (smallest -> largest)."""
    base_w: np.ndarray       # (S,) idle power per slice
    peak_w: np.ndarray       # (S,) full-utilization power
    multiple: np.ndarray     # (S,) capacity relative to baseline
    bw_gbps: np.ndarray      # (S,) migration-path bandwidth
    next_smaller: np.ndarray  # (S,) index of next available smaller; -1 none
    next_larger: np.ndarray   # (S,) index of next available larger; -1 none
    smallest: int
    baseline_idx: int
    names: tuple
    well_formed: bool = True  # every slice has peak_w > base_w

    def to(self, device) -> SliceTensors:
        f = dict(dtype=torch.float64, device=device)
        i = dict(dtype=torch.int64, device=device)
        return SliceTensors(
            base_w=torch.as_tensor(self.base_w, **f),
            peak_w=torch.as_tensor(self.peak_w, **f),
            multiple=torch.as_tensor(self.multiple, **f),
            bw_gbps=torch.as_tensor(self.bw_gbps, **f),
            next_smaller=torch.as_tensor(self.next_smaller, **i),
            next_larger=torch.as_tensor(self.next_larger, **i))


def paper_family() -> SliceFamily:
    """The paper's AWS-like family: 0.25x..4x, 100/200 W baseline."""
    base = LinearPowerModel(100.0, 200.0)
    slices = [Slice(f"x{m:g}", m, base.scale(m)) for m in
              (0.25, 0.5, 1.0, 2.0, 4.0)]
    return SliceFamily(slices, baseline_idx=2)


def tpu_v5e_family(chip_idle_w: float = 75.0, chip_peak_w: float = 200.0,
                   host_w: float = 150.0, chips_per_host: int = 8,
                   baseline_chips: int = 64) -> SliceFamily:
    """TPU v5e slices 16..256 chips; power = chips·(idle..peak) + hosts."""
    slices = []
    for chips in (16, 32, 64, 128, 256):
        hosts = chips // chips_per_host
        pm = LinearPowerModel(chips * chip_idle_w + hosts * host_w,
                              chips * chip_peak_w + hosts * host_w)
        slices.append(Slice(f"v5e-{chips}", chips / baseline_chips, pm,
                            chips=chips, state_bw_gbps=2.0 * hosts))
    return SliceFamily(slices, baseline_idx=2)
