"""The virtual energy supply step on a device.

`energy_step` is `repro_torch.energy.supply.supply_step_np` term for
term on (R,)-shaped float64 tensors; the fleet scan
(`repro_torch.core.fleet._fleet_scan`) folds it into its epoch step
with an (R,) battery state-of-charge carry. Each product and sum is its
own tensor op, as in the NumPy step: no fused op (`addcmul`, `lerp`)
that could contract a product and a sum into one rounding, and the
quotient by a constant is `devmath.divide` (the card's scalar division
multiplies by a reciprocal). The
drained-battery snap (`SOC_SNAP_WH`) is kept as in the NumPy step.

`simulate_supply_torch` runs the step over T epochs and returns the
host `SupplyResult` ledger, like `simulate_supply`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.devmath import divide
from repro_torch.energy.supply import SOC_SNAP_WH, EnergySpec, SupplyResult


def energy_step(spec: EnergySpec, soc, load, solar, grid_c, up):
    """One supply epoch on (R,) tensors. Returns ``(soc1, (solar_used,
    charge, discharge, grid, supplied, cap_frac, c_eff))``."""
    use_solar = torch.minimum(load, solar)
    surplus = solar - use_solar
    head_w = divide((spec.cap_wh - soc) * (3600.0 / spec.dt), spec.eta_c)
    charge = torch.clamp(torch.minimum(
        torch.clamp(surplus, max=spec.max_charge_w), head_w), min=0.0)
    deficit = load - use_solar
    avail_w = soc * (3600.0 / spec.dt)
    discharge = torch.clamp(torch.minimum(
        torch.clamp(deficit, max=spec.max_discharge_w), avail_w), min=0.0)
    grid = (deficit - discharge) * up
    supplied = use_solar + discharge + grid
    soc1 = soc + (charge * spec.eta_c - discharge) * (spec.dt / 3600.0)
    soc1 = torch.where(soc1 < SOC_SNAP_WH, 0.0, soc1)
    load_pos = load > 0.0
    cap_frac = torch.where(
        load_pos,
        torch.clamp(supplied / torch.where(load_pos, load, 1.0), max=1.0),
        1.0)
    sup_pos = supplied > 0.0
    c_eff = grid_c * torch.where(
        sup_pos, grid / torch.where(sup_pos, supplied, 1.0), 1.0)
    return soc1, (use_solar, charge, discharge, grid, supplied, cap_frac,
                  c_eff)


def simulate_supply_torch(load, solar, grid_c, grid_up, spec: EnergySpec,
                          device="cuda") -> SupplyResult:
    """`energy_step` over T epochs on `device`; all inputs (T, R)."""
    dev = resolve_device(device)
    host = [np.asarray(a, dtype=np.float64)
            for a in (load, solar, grid_c, grid_up)]
    if len({a.shape for a in host}) != 1 or host[0].ndim != 2:
        raise ValueError(f"supply inputs must be equal (T, R); got "
                         f"{[a.shape for a in host]}")
    T, R = host[0].shape
    ld, sl, gc, gu = (torch.as_tensor(a, device=dev) for a in host)
    soc = torch.full((R,), spec.soc0_wh, dtype=torch.float64, device=dev)
    outs = torch.empty((8, T, R), dtype=torch.float64, device=dev)
    for t in range(T):
        soc, step = energy_step(spec, soc, ld[t], sl[t], gc[t], gu[t])
        for k, v in enumerate(step):
            outs[k, t] = v
        outs[7, t] = soc
    (solar_used, charge, discharge, grid, supplied, cap_frac, c_eff,
     soc_tr) = outs.cpu().numpy()
    return SupplyResult(load=host[0], solar_gen=host[1],
                        solar_used=solar_used, charge=charge,
                        discharge=discharge, grid=grid, supplied=supplied,
                        cap_frac=cap_frac, c_eff=c_eff, soc=soc_tr,
                        grid_up=host[3], spec=spec)
