"""Per-region virtual energy supply: solar + battery + (perturbed) grid.

Host numpy, copied from `repro.energy.supply`. Ecovisor ("A Virtual
Energy System for Carbon-Efficient Applications") virtualizes the energy
system: applications see a software-defined
supply — solar partitions, battery partitions with charge/discharge
limits, and a grid connection — instead of the physical one, and adapt
to supply signals rather than the other way round. This module is that
supply side for the sweep substrate:

  - `solar_series` generates per-region solar traces (time-zone-shifted
    clear-sky arc x a seeded AR(1) weather factor);
  - `event_matrices` generates the grid-event layer: outage windows
    (grid draw forced to zero) and multiplicative carbon-intensity
    shocks, either scheduled explicitly or sampled from a seed —
    region -1 addresses *all* regions at once (a correlated spike);
  - `supply_step_np` advances one epoch of the supply for all R regions
    (the battery state of charge is the only carry), producing the two
    signals the demand side consumes: `cap_frac`, the virtual power cap
    as a fraction of the region's offered flexible load, and `c_eff`,
    the delivered mix's effective carbon intensity (solar and battery
    draw are zero-carbon; grid draw carries the grid intensity);
  - `simulate_supply` scans the step over T epochs into a
    `SupplyResult` ledger with the sweep's invariant metrics: energy
    conservation (solar_used + battery + grid == supplied), zero
    virtual-cap violations, battery SoC within [0, capacity].

Metering model: the virtual partition meters the fleet's *flexible*
(demand-proportional) power at the baseline slice, ``p_flex =
span_b / mult_b * demand`` per container — linear in demand, so
enforcing the cap by scaling demand with `cap_frac` lands the enforced
load exactly on the supplied power (violations are zero by
construction; the check catches coding errors, same philosophy as the
placement capacity and elastic budget gates). Idle power sits outside
the partition and is billed at the effective mix intensity.

`repro_torch.energy.supply_torch.energy_step` is `supply_step_np` term
for term on (R,)-shaped tensors, so the fleet scan folds the supply
step into its epoch step with an (R,) SoC carry only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np


@dataclass(frozen=True)
class SolarConfig:
    """Per-region solar array sized relative to the fleet.

    `peak_w_per_container` scales the array with the fleet (each
    region's peak is ``peak_w_per_container * n_containers / R``), so
    scenarios are fleet-size invariant. `tz_offset_h` shifts each
    region's solar day (None: evenly spread over 24 h, matching the
    traffic population's default); the clear-sky arc is a half-sine
    between `sunrise_h` and `sunset_h`, scaled by a seeded AR(1)
    weather factor (clouds).
    """
    peak_w_per_container: float = 150.0
    tz_offset_h: Optional[tuple] = None
    sunrise_h: float = 6.0
    sunset_h: float = 18.0
    weather_rho: float = 0.9
    weather_sigma: float = 0.1
    seed: int = 0


@dataclass(frozen=True)
class BatteryConfig:
    """Per-region battery partition, sized per container like solar.

    `eta_charge` is the one-way charge efficiency (losses land in the
    SoC ledger at charge time; discharge delivers 1:1 from the SoC, so
    conservation on the *delivered* side is exact).
    """
    capacity_wh_per_container: float = 40.0
    max_charge_w_per_container: float = 60.0
    max_discharge_w_per_container: float = 60.0
    eta_charge: float = 0.9
    soc0_frac: float = 0.5


@dataclass(frozen=True)
class GridEventConfig:
    """Grid events perturbing the supply and the carbon inputs.

    `outages` are explicit ``(region, start_epoch, n_epochs)`` windows
    (region -1 = every region: a correlated blackout); during an outage
    the region's grid draw is forced to zero, so the fleet rides on
    solar + battery and the virtual cap clamps whatever they cannot
    cover. `shocks` are explicit ``(region, start_epoch, n_epochs,
    factor)`` multiplicative carbon-intensity spikes (region -1 = all
    regions: a correlated regional spike); the perturbed intensity is
    what the placement planner, traffic router, and elasticity layer
    all consume. `n_random_outages` / `n_random_shocks` add seeded
    random windows on top (deterministic per seed).
    """
    outages: tuple = ()
    shocks: tuple = ()
    n_random_outages: int = 0
    outage_len: tuple = (3, 12)
    n_random_shocks: int = 0
    shock_len: tuple = (6, 24)
    shock_factor: tuple = (1.5, 3.0)
    seed: int = 0


@dataclass(frozen=True)
class EnergyConfig:
    """The energy layer's sweep sub-spec (``energy=`` / SweepSpec.energy)."""
    solar: SolarConfig = field(default_factory=SolarConfig)
    battery: BatteryConfig = field(default_factory=BatteryConfig)
    events: GridEventConfig = field(default_factory=GridEventConfig)


class EnergySpec(NamedTuple):
    """Hashable fleet-scaled supply constants, shared by the NumPy step
    and the device fold."""
    cap_wh: float            # per-region battery capacity
    max_charge_w: float
    max_discharge_w: float
    eta_c: float
    soc0_wh: float
    load_coef: float         # flexible W per unit demand (span_b/mult_b)
    solar_peak_w: float      # per-region array peak
    dt: float

    @classmethod
    def from_config(cls, cfg: EnergyConfig, n_containers: int,
                    n_regions: int, interval_s: float,
                    flex_w_per_unit: float) -> "EnergySpec":
        per_r = float(n_containers) / float(n_regions)
        b = cfg.battery
        return cls(
            cap_wh=b.capacity_wh_per_container * per_r,
            max_charge_w=b.max_charge_w_per_container * per_r,
            max_discharge_w=b.max_discharge_w_per_container * per_r,
            eta_c=float(b.eta_charge),
            soc0_wh=b.capacity_wh_per_container * per_r * float(b.soc0_frac),
            load_coef=float(flex_w_per_unit),
            solar_peak_w=cfg.solar.peak_w_per_container * per_r,
            dt=float(interval_s))


def flex_w_per_unit(family) -> float:
    """Flexible (demand-proportional) W per unit demand on the family's
    baseline slice: span_b / mult_b."""
    t = family.tables()
    b = t.baseline_idx
    return float((t.peak_w[b] - t.base_w[b]) / t.multiple[b])


def solar_series(cfg: SolarConfig, T: int, n_regions: int,
                 interval_s: float, peak_w: float) -> np.ndarray:
    """(T, R) solar generation in W: clear-sky half-sine arc per region
    (time-zone shifted) x seeded AR(1) weather factor."""
    R = n_regions
    tz = cfg.tz_offset_h
    if tz is None:
        tz = tuple(24.0 * r / R for r in range(R))
    if len(tz) != R:
        raise ValueError(f"tz_offset_h has {len(tz)} entries for "
                         f"{R} regions")
    h = (np.arange(T, dtype=np.float64) * interval_s / 3600.0)[:, None] \
        + np.asarray(tz, dtype=np.float64)[None, :]
    h = np.mod(h, 24.0)
    daylen = cfg.sunset_h - cfg.sunrise_h
    arc = np.sin(np.pi * (h - cfg.sunrise_h) / daylen)
    arc = np.where((h >= cfg.sunrise_h) & (h <= cfg.sunset_h),
                   np.maximum(arc, 0.0), 0.0)
    rng = np.random.default_rng(cfg.seed)
    x = np.zeros(R)
    weather = np.empty((T, R))
    for t in range(T):
        x = cfg.weather_rho * x + cfg.weather_sigma * rng.standard_normal(R)
        weather[t] = np.clip(0.85 + x, 0.0, 1.0)
    return peak_w * arc * weather


def event_matrices(cfg: GridEventConfig, T: int, n_regions: int):
    """Materialize the grid events as ``(shock_mult (T, R) f64,
    grid_up (T, R) f64 in {0, 1})``; deterministic per seed."""
    R = n_regions
    mult = np.ones((T, R), dtype=np.float64)
    up = np.ones((T, R), dtype=np.float64)
    rng = np.random.default_rng(cfg.seed)

    def _regions(r):
        return range(R) if int(r) < 0 else (int(r),)

    events = [(r, s, n, None) for (r, s, n) in cfg.outages]
    for _ in range(cfg.n_random_outages):
        events.append((int(rng.integers(0, R)),
                       int(rng.integers(0, max(T - 1, 1))),
                       int(rng.integers(cfg.outage_len[0],
                                        cfg.outage_len[1] + 1)), None))
    for ev in cfg.shocks:
        events.append(ev)
    for _ in range(cfg.n_random_shocks):
        events.append((int(rng.integers(0, R)),
                       int(rng.integers(0, max(T - 1, 1))),
                       int(rng.integers(cfg.shock_len[0],
                                        cfg.shock_len[1] + 1)),
                       float(rng.uniform(*cfg.shock_factor))))
    for r, start, n, factor in events:
        lo = max(0, int(start))
        hi = min(T, int(start) + int(n))
        if hi <= lo:
            continue
        for rr in _regions(r):
            if factor is None:
                up[lo:hi, rr] = 0.0
            else:
                mult[lo:hi, rr] *= float(factor)
    return mult, up


# Drained-battery snap: when a discharge empties the battery, the exact
# algebra leaves SoC at 0 but the rounding of soc - (soc*(3600/dt))*
# (dt/3600) (and any FMA contraction of the same expression) can leave
# a ~1e-13 Wh residue. During an outage that residue discharges as a
# femto-watt `supplied`, flipping the supplied>0 branch of c_eff from
# "idle at grid intensity" to "100% battery, zero carbon" — a last-bit
# difference amplified into a full billing change. Snapping sub-nano-Wh
# SoC to zero in every step implementation keeps the branch (and the
# cross-backend parity) robust.
SOC_SNAP_WH = 1e-9


def supply_step_np(spec: EnergySpec, soc, load, solar, grid_c, up):
    """One epoch of the supply for all R regions (NumPy (R,) arrays).

    Feed-forward dispatch order: solar first, surplus charges the
    battery (rate/headroom-bounded, charge losses to the SoC ledger),
    deficit discharges the battery (rate/SoC-bounded), the remainder
    draws grid — zero during an outage, leaving the cap short of the
    load. Returns ``(soc1, (solar_used, charge, discharge, grid,
    supplied, cap_frac, c_eff))``. `supply_torch.energy_step` mirrors
    this term for term; keep the two in lockstep.
    """
    use_solar = np.minimum(load, solar)
    surplus = solar - use_solar
    head_w = (spec.cap_wh - soc) * (3600.0 / spec.dt) / spec.eta_c
    charge = np.maximum(
        np.minimum(np.minimum(surplus, spec.max_charge_w), head_w), 0.0)
    deficit = load - use_solar
    avail_w = soc * (3600.0 / spec.dt)
    discharge = np.maximum(
        np.minimum(np.minimum(deficit, spec.max_discharge_w), avail_w), 0.0)
    grid = (deficit - discharge) * up
    supplied = use_solar + discharge + grid
    soc1 = soc + (charge * spec.eta_c - discharge) * (spec.dt / 3600.0)
    soc1 = np.where(soc1 < SOC_SNAP_WH, 0.0, soc1)
    load_pos = load > 0.0
    cap_frac = np.where(
        load_pos,
        np.minimum(supplied / np.where(load_pos, load, 1.0), 1.0), 1.0)
    sup_pos = supplied > 0.0
    c_eff = grid_c * np.where(
        sup_pos, grid / np.where(sup_pos, supplied, 1.0), 1.0)
    return soc1, (use_solar, charge, discharge, grid, supplied, cap_frac,
                  c_eff)


def supply_step_scalar(spec: EnergySpec, soc: float, load: float,
                       solar: float, grid_c: float, up: float):
    """Pure-float step for one region, bit-identical to
    `supply_step_np` (`simulate_supply`'s inner loop)."""
    use_solar = min(load, solar)
    surplus = solar - use_solar
    head_w = (spec.cap_wh - soc) * (3600.0 / spec.dt) / spec.eta_c
    charge = max(min(min(surplus, spec.max_charge_w), head_w), 0.0)
    deficit = load - use_solar
    avail_w = soc * (3600.0 / spec.dt)
    discharge = max(min(min(deficit, spec.max_discharge_w), avail_w), 0.0)
    grid = (deficit - discharge) * up
    supplied = use_solar + discharge + grid
    soc1 = soc + (charge * spec.eta_c - discharge) * (spec.dt / 3600.0)
    soc1 = 0.0 if soc1 < SOC_SNAP_WH else soc1
    cap_frac = min(supplied / load, 1.0) if load > 0.0 else 1.0
    c_eff = grid_c * (grid / supplied if supplied > 0.0 else 1.0)
    return soc1, (use_solar, charge, discharge, grid, supplied, cap_frac,
                  c_eff)


@dataclass
class SupplyResult:
    """(T, R) supply ledger + the sweep's invariant metrics."""
    load: np.ndarray             # offered flexible load (W)
    solar_gen: np.ndarray        # available solar (W)
    solar_used: np.ndarray
    charge: np.ndarray
    discharge: np.ndarray
    grid: np.ndarray
    supplied: np.ndarray
    cap_frac: np.ndarray
    c_eff: np.ndarray
    soc: np.ndarray              # end-of-epoch state of charge (Wh)
    grid_up: np.ndarray
    spec: EnergySpec

    _TOL = 1e-9

    @property
    def unmet(self) -> np.ndarray:
        return self.load - self.supplied

    @property
    def conservation_max_err_w(self) -> float:
        """max |solar_used + battery + grid - supplied| over (t, r)."""
        err = self.solar_used + self.discharge + self.grid - self.supplied
        return float(np.max(np.abs(err))) if err.size else 0.0

    @property
    def cap_violations(self) -> int:
        """Epochs where the *enforced* load (load x cap_frac) exceeds
        the supplied power: zero by construction; nonzero = bug."""
        scale = max(float(np.max(self.load, initial=0.0)), 1.0)
        bad = (self.load * self.cap_frac
               > self.supplied + self._TOL * scale)
        return int(np.sum(bad))

    @property
    def soc_violations(self) -> int:
        tol = self._TOL * max(self.spec.cap_wh, 1.0)
        bad = (self.soc < -tol) | (self.soc > self.spec.cap_wh + tol)
        return int(np.sum(bad))

    def summary(self) -> dict:
        wh = self.spec.dt / 3600.0
        sup = max(float(self.supplied.sum()) * wh, 1e-12)
        load_wh = max(float(self.load.sum()) * wh, 1e-12)
        return {
            "energy_solar_wh": float(self.solar_used.sum()) * wh,
            "energy_battery_wh": float(self.discharge.sum()) * wh,
            "energy_grid_wh": float(self.grid.sum()) * wh,
            "energy_supplied_wh": float(self.supplied.sum()) * wh,
            "energy_unmet_frac": float(self.unmet.sum()) * wh / load_wh,
            "energy_solar_frac": float(self.solar_used.sum()) * wh / sup,
            "energy_grid_frac": float(self.grid.sum()) * wh / sup,
            "energy_cap_frac_min": (float(self.cap_frac.min())
                                    if self.cap_frac.size else 1.0),
            "energy_outage_epochs": int(np.sum(self.grid_up <= 0.0)),
            "energy_conservation_max_err_w": self.conservation_max_err_w,
            "energy_cap_violations": self.cap_violations,
            "energy_soc_violations": self.soc_violations,
        }


def simulate_supply(load, solar, grid_c, grid_up,
                    spec: EnergySpec) -> SupplyResult:
    """Scan `supply_step_np` over T epochs; all inputs (T, R)."""
    load = np.asarray(load, dtype=np.float64)
    solar = np.asarray(solar, dtype=np.float64)
    grid_c = np.asarray(grid_c, dtype=np.float64)
    grid_up = np.asarray(grid_up, dtype=np.float64)
    if not (load.shape == solar.shape == grid_c.shape == grid_up.shape):
        raise ValueError(f"supply inputs disagree: load {load.shape}, "
                         f"solar {solar.shape}, grid {grid_c.shape}, "
                         f"up {grid_up.shape}")
    T, R = load.shape
    # scalar inner loop: T x R pure-float steps beat T numpy calls on
    # (R,)-wide arrays by ~10x (this sim is most of the energy layer's
    # overhead at the bench gate); supply_step_scalar is pinned
    # bit-identical to supply_step_np by the test suite, so the ledger
    # is unchanged down to the last bit
    outs = np.empty((8, T, R), dtype=np.float64)
    ld, sl, gc, gu = (load.tolist(), solar.tolist(), grid_c.tolist(),
                      grid_up.tolist())
    soc_r = [spec.soc0_wh] * R
    buf = outs.reshape(8, T * R)
    for r in range(R):
        soc = soc_r[r]
        for t in range(T):
            soc, step = supply_step_scalar(spec, soc, ld[t][r], sl[t][r],
                                           gc[t][r], gu[t][r])
            i = t * R + r
            (buf[0][i], buf[1][i], buf[2][i], buf[3][i], buf[4][i],
             buf[5][i], buf[6][i]) = step
            buf[7][i] = soc
    (solar_used, charge, discharge, grid, supplied, cap_frac,
     c_eff, soc_tr) = outs
    return SupplyResult(load=load, solar_gen=solar, solar_used=solar_used,
                        charge=charge, discharge=discharge, grid=grid,
                        supplied=supplied, cap_frac=cap_frac, c_eff=c_eff,
                        soc=soc_tr, grid_up=grid_up, spec=spec)
