"""Carry the reference's state into the port.

`from_reference_arrays`: the fleet sweep has no learned weights; its
parameters are the slice tables, the migration model and the placement
plan. It takes those as the reference hands them out, as plain numpy
arrays and Python values (for example ``vars(plan)`` of a reference
`PlacementPlan` and ``vars(tables)`` of its `FamilyTables`), and
returns the port's objects, so a plan computed on one side drives the
other side's fleet scan.

`from_reference_params`: a model's parameters, as the reference's
nested dict of arrays (for example ``jax.tree.map(np.asarray, params)``),
checked leaf by leaf against the port's specs and returned as tensors.

`from_reference_state`: a train state of the reference (``{"params",
"opt": {"m", "v"}, "step" [, "ef"]}``, numpy arrays) as the port's
train state, so both packages can take the same steps from it.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.cluster.placement import PlacementPlan
from repro_torch.cluster.slices import FamilyTables
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.models.params import DTYPES, flatten, unflatten


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


def from_reference_params(cfg, tree: Mapping, device="cuda") -> dict:
    """The reference's parameter tree for `cfg` (nested dicts of numpy
    arrays) as the port's parameter dict on `device`. Every leaf of the
    port's `specs(cfg)` must be present with its shape, and nothing else."""
    dev = resolve_device(device)
    spec_tree = get_model(cfg).specs()
    specs = dict(flatten(spec_tree))
    given = dict(flatten(tree))
    if set(given) != set(specs):
        raise ValueError(f"parameter paths differ: missing "
                         f"{sorted(set(specs) - set(given))}, unexpected "
                         f"{sorted(set(given) - set(specs))}")
    leaves = {}
    for path, spec in specs.items():
        arr = np.asarray(given[path], dtype=np.float32)
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected "
                             f"{tuple(spec.shape)}")
        leaves[path] = torch.from_numpy(arr.copy()).to(
            device=dev, dtype=DTYPES[spec.dtype])
    return unflatten(spec_tree, leaves)


def from_reference_state(cfg, state: Mapping, device="cuda") -> dict:
    """The reference's train state for `cfg` (nested dicts of numpy
    arrays) as the port's: params in their specs' dtypes, the optimizer
    moments and the error feedback (where present) float32 with the
    params' paths, the step an int32 0-d tensor."""
    dev = resolve_device(device)
    spec_tree = get_model(cfg).specs()

    def f32_tree(tree, name):
        given = dict(flatten(tree))
        paths = [p for p, _ in flatten(spec_tree)]
        if set(given) != set(paths):
            raise ValueError(f"{name} paths differ from the parameters'")
        return unflatten(spec_tree, {p: torch.from_numpy(np.array(
            given[p], dtype=np.float32)).to(dev) for p in paths})

    out = {"params": from_reference_params(cfg, state["params"], dev),
           "opt": {k: f32_tree(state["opt"][k], f"opt/{k}")
                   for k in ("m", "v")},
           "step": torch.tensor(int(np.asarray(state["step"])),
                                dtype=torch.int32, device=dev)}
    if "ef" in state:
        out["ef"] = f32_tree(state["ef"], "ef")
    return out
