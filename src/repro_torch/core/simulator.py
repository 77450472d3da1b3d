"""Trace-driven Carbon Containers simulator (paper §5.3, Figs 10-17), the
port's copy of `repro.core.simulator` (host Python, the reference's
operations in the reference's order, so its results are the reference's
bits).

Drives any policy against a (workload-intensity trace × carbon-intensity
trace) pair on a slice family, one decision per monitoring interval,
including migration downtime from the Fig.-7 cost model (both slices
powered during a stop-and-copy, no work served). `SimConfig` also holds
the settings of the device sweep (`repro_torch.core.fleet`).
`sweep_population` is the reference's keyword front door to a
population sweep.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.carbon.intensity import CarbonIntensityProvider
from repro_torch.cluster.migration import MigrationCostModel
from repro_torch.cluster.slices import SliceFamily
from repro_torch.core.container import ContainerState, PlantModel
from repro_torch.core.policy import Action


@dataclass
class SimConfig:
    target_rate: float                  # g CO2e/hr
    epsilon: float = 0.05
    interval_s: float = 300.0
    state_gb: float = 1.0               # migrated state footprint (Fig. 7)
    suspend_releases_slice: bool = True  # cloud-user view: release = no power
    record_series: bool = False


@dataclass
class SimResult:
    avg_carbon_rate: float              # g/hr
    avg_throttle_pct: float             # % of baseline capacity unserved
    work_done: float
    work_demanded: float
    energy_kwh: float
    migrations: int
    suspended_frac: float
    time_on_slice: dict
    emissions_g: float
    hours: float
    series: Optional[dict] = None

    @property
    def carbon_efficiency(self) -> float:
        """Work done per kg CO2e (the paper's figure of merit)."""
        return self.work_done / max(self.emissions_g / 1000.0, 1e-12)


def simulate(policy, family: SliceFamily, util_trace: Sequence[float],
             carbon: CarbonIntensityProvider, cfg: SimConfig,
             demand_scale: float = 1.0,
             migration: Optional[MigrationCostModel] = None,
             carbon_obs=None) -> SimResult:
    """Run one container over `util_trace` under `policy`.

    `carbon_obs` (optional) splits the signal plane from the billing
    plane: the policy *decides* on the observed intensity (a provider,
    or a per-epoch sequence aligned with `util_trace`) while emissions
    are billed at the true `carbon`."""
    mig = migration or MigrationCostModel()
    st = ContainerState(slice_idx=family.baseline_idx)
    st.dwell = 10**6
    dt = cfg.interval_s
    series: dict = {"t": [], "carbon_rate": [], "slice": [], "duty": [],
                    "util": [], "demand": [], "served": []}

    for n, demand_raw in enumerate(util_trace):
        t = n * dt
        demand = float(demand_raw) * demand_scale
        c = carbon.intensity(t)
        if carbon_obs is None:
            c_obs = c
        elif hasattr(carbon_obs, "intensity"):
            c_obs = carbon_obs.intensity(t)
        else:
            c_obs = float(carbon_obs[n])
        st.demand_integral += demand * dt
        st.elapsed_s += dt
        st.observe_demand(demand)

        # ----- migration in progress: both slices powered, no work --------
        if st.migrating_s > 0:
            src = family[st.slice_idx]
            dst = family[st.migrate_target]
            power = PlantModel.idle_power(src) + PlantModel.idle_power(dst)
            _account(st, family, power, c, served=0.0, demand=demand, dt=dt)
            st.migrating_s -= dt
            if st.migrating_s <= 0:
                st.slice_idx = st.migrate_target
                st.migrate_target = None
                st.dwell = 0
            _record(series, cfg, t, power * c / 1000.0, st, 0.0, demand, 0.0)
            continue

        action: Action = policy.decide(family, st, demand, c_obs,
                                       cfg.target_rate, cfg.epsilon)

        if action.kind == "suspend":
            st.suspended = True
            st.suspended_s += dt
            if cfg.suspend_releases_slice:
                power = 0.0
            else:
                power = PlantModel.idle_power(family[st.slice_idx])
            _account(st, family, power, c, served=0.0, demand=demand, dt=dt)
            _record(series, cfg, t, power * c / 1000.0, st, 0.0, demand, 0.0)
            st.dwell += 1
            continue

        if action.kind == "resume":
            st.suspended = False
            if action.target_slice is not None:
                st.slice_idx = action.target_slice
            st.duty = action.duty

        elif action.kind == "migrate":
            st.migrate_target = action.target_slice
            st.duty = action.duty
            st.migrations += 1
            bw = max(family[st.slice_idx].state_bw_gbps,
                     family[action.target_slice].state_bw_gbps)
            mig_s = mig.stop_and_copy_time(cfg.state_gb, transfer_gbps=bw)
            src = family[st.slice_idx]
            dst = family[action.target_slice]
            down_frac = min(mig_s, dt) / dt
            p_mig = PlantModel.idle_power(src) + PlantModel.idle_power(dst)
            if mig_s >= dt:
                # long migration: whole interval down
                st.migrating_s = mig_s - dt
                _account(st, family, p_mig, c, served=0.0, demand=demand, dt=dt)
                _record(series, cfg, t, p_mig * c / 1000.0, st, 0.0, demand, 0.0)
                continue
            # sub-interval migration: serve the rest of it on the destination
            st.slice_idx = st.migrate_target
            st.migrate_target = None
            st.dwell = 0
            step = PlantModel.run(family[st.slice_idx], st.duty, demand, c)
            power = down_frac * p_mig + (1 - down_frac) * step.power_w
            served = (1 - down_frac) * step.served
            _account(st, family, power, c, served=served, demand=demand, dt=dt)
            _record(series, cfg, t, power * c / 1000.0, st, step.util,
                    demand, served)
            continue

        else:  # stay
            st.duty = action.duty

        step = PlantModel.run(family[st.slice_idx], st.duty, demand, c)
        _account(st, family, step.power_w, c, served=step.served,
                 demand=demand, dt=dt)
        _record(series, cfg, t, step.carbon_rate, st, step.util, demand,
                step.served)
        st.dwell += 1

    hours = st.elapsed_s / 3600.0
    baseline_cap = family.baseline.multiple
    thr_pct = 100.0 * st.throttled_integral / max(st.elapsed_s, 1e-9) / baseline_cap
    return SimResult(
        avg_carbon_rate=st.emissions_g / max(hours, 1e-12),
        avg_throttle_pct=thr_pct,
        work_done=st.work_done,
        work_demanded=st.demand_integral,
        energy_kwh=st.energy_wh / 1000.0,
        migrations=st.migrations,
        suspended_frac=st.suspended_s / max(st.elapsed_s, 1e-9),
        time_on_slice={k: v / max(st.elapsed_s, 1e-9)
                       for k, v in st.time_on_slice_s.items()},
        emissions_g=st.emissions_g,
        hours=hours,
        series=series if cfg.record_series else None,
    )


def _account(st: ContainerState, family, power_w, c, served, demand, dt):
    st.energy_wh += power_w * dt / 3600.0
    st.emissions_g += power_w * c / 1000.0 * dt / 3600.0
    st.work_done += served * dt
    st.throttled_integral += max(0.0, demand - served) * dt
    name = "suspended" if st.suspended else family[st.slice_idx].name
    st.time_on_slice_s[name] = st.time_on_slice_s.get(name, 0.0) + dt


def _record(series, cfg, t, rate, st, util, demand, served):
    if not cfg.record_series:
        return
    series["t"].append(t)
    series["carbon_rate"].append(rate)
    series["slice"].append("susp" if st.suspended else st.slice_idx)
    series["duty"].append(st.duty)
    series["util"].append(util)
    series["demand"].append(demand)
    series["served"].append(served)


# ---------------------------------------------------------------------------
# Population sweep (Figs 11-16): many jobs x many targets x policies
# ---------------------------------------------------------------------------

def sweep_population(policies, family: SliceFamily = None, traces=None,
                     carbon=None, targets: Sequence[float] = None,
                     cfg_base: SimConfig = None, demand_scale: float = 1.0,
                     backend: str = "torch", placement=None, traffic=None,
                     elasticity=None, energy=None, faults=None,
                     device="cuda"):
    """Run a population sweep: every (policy x target x trace) combination.

    Pass a `repro_torch.core.spec.SweepSpec` as the first argument and get
    its `SweepResult` back (`SweepSpec.run()`). The keyword surface below
    is the reference's shim: it builds the spec and returns the bare row
    list ({policy, target, mean/std of carbon rate and throttle, ...}).

    `backend="torch"` runs `sweep_population_torch` on `device`, with the
    placement, traffic, elasticity, energy and fault layers (see
    `SweepSpec`). `backend="scalar"` runs the host `simulate` once per
    (policy x target x trace), in the reference's row order, on no layer.
    """
    from repro_torch.core.spec import SweepSpec
    if isinstance(policies, SweepSpec):
        if family is not None or traces is not None:
            raise TypeError("pass either a SweepSpec or the kwargs "
                            "surface, not both")
        return policies.run()
    cfg_base = cfg_base if cfg_base is not None else SimConfig(target_rate=0.0)
    if backend == "torch":
        return SweepSpec(policies=policies, family=family, traces=traces,
                         targets=targets, carbon=carbon, sim=cfg_base,
                         demand_scale=demand_scale, backend=backend,
                         placement=placement, traffic=traffic,
                         elasticity=elasticity, energy=energy, faults=faults,
                         device=device).run().rows
    if backend != "scalar":
        raise ValueError(f"unknown sweep backend {backend!r}; the port takes "
                         f"'torch' or 'scalar'")
    for name, layer in (("placement", placement), ("traffic", traffic),
                        ("elasticity", elasticity), ("energy", energy),
                        ("faults", faults)):
        if layer is not None:
            raise ValueError(f"{name} requires backend='torch'")
    rows = []
    for target in targets:
        for name, mk_policy in policies.items():
            rates, thr, migs, susp = [], [], [], []
            slice_time: dict = {}
            for tr in traces:
                cfg = SimConfig(target_rate=target, epsilon=cfg_base.epsilon,
                                interval_s=cfg_base.interval_s,
                                state_gb=cfg_base.state_gb,
                                suspend_releases_slice=cfg_base.suspend_releases_slice)
                res = simulate(mk_policy(), family, tr, carbon, cfg,
                               demand_scale=demand_scale)
                rates.append(res.avg_carbon_rate)
                thr.append(res.avg_throttle_pct)
                migs.append(res.migrations)
                susp.append(res.suspended_frac)
                for k, v in res.time_on_slice.items():
                    slice_time[k] = slice_time.get(k, 0.0) + v / len(traces)
            rows.append({
                "policy": name, "target": target,
                "carbon_rate_mean": float(np.mean(rates)),
                "carbon_rate_std": float(np.std(rates)),
                "throttle_mean": float(np.mean(thr)),
                "throttle_std": float(np.std(thr)),
                "migrations_mean": float(np.mean(migs)),
                "suspended_frac_mean": float(np.mean(susp)),
                "time_on_slice": slice_time,
            })
    return rows
