"""Carry the reference's state into the port.

This slice has no learned weights: its parameters are the slice tables,
the migration model and the placement plan. `from_reference_arrays`
takes those as the reference hands them out, as plain numpy arrays and
Python values (for example ``vars(plan)`` of a reference
`PlacementPlan` and ``vars(tables)`` of its `FamilyTables`), and
returns the port's objects, so a plan computed on one side drives the
other side's fleet scan.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from repro_torch.cluster.placement import PlacementPlan
from repro_torch.cluster.slices import FamilyTables


def from_reference_arrays(plan: Optional[Mapping] = None,
                          tables: Optional[Mapping] = None):
    """Returns ``(PlacementPlan | None, FamilyTables | None)``.

    `plan` needs every `PlacementPlan` field; `tables` every
    `FamilyTables` field. Shapes and region indices are checked.
    """
    out_plan = out_tables = None
    if plan is not None:
        assign = np.array(plan["assign"], dtype=np.int64)
        reg = np.array(plan["region_intensity"], dtype=np.float64)
        if assign.ndim != 2 or reg.ndim != 2 or reg.shape[0] != assign.shape[0]:
            raise ValueError(f"plan shapes assign {assign.shape}, "
                             f"region_intensity {reg.shape}; expected "
                             f"(T, N) and (T, R)")
        if assign.size and (assign.min() < 0 or assign.max() >= reg.shape[1]):
            raise ValueError("plan assignment region out of range")
        out_plan = PlacementPlan(
            assign=assign,
            migrations=np.array(plan["migrations"], dtype=np.int64),
            overhead_g=np.array(plan["overhead_g"], dtype=np.float64),
            downtime_s=np.array(plan["downtime_s"], dtype=np.float64),
            region_intensity=reg,
            region_names=tuple(plan["region_names"]),
            initial=np.array(plan["initial"], dtype=np.int64))
    if tables is not None:
        out_tables = FamilyTables(
            base_w=np.array(tables["base_w"], dtype=np.float64),
            peak_w=np.array(tables["peak_w"], dtype=np.float64),
            multiple=np.array(tables["multiple"], dtype=np.float64),
            bw_gbps=np.array(tables["bw_gbps"], dtype=np.float64),
            next_smaller=np.array(tables["next_smaller"], dtype=np.int64),
            next_larger=np.array(tables["next_larger"], dtype=np.int64),
            smallest=int(tables["smallest"]),
            baseline_idx=int(tables["baseline_idx"]),
            names=tuple(tables["names"]),
            well_formed=bool(tables["well_formed"]))
    return out_plan, out_tables
