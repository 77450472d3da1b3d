"""Per-container elasticity: CarbonScaler marginal allocation over (N, K).

Host numpy, copied from `repro.core.elasticity` (the NumPy layer; its
device counterpart is `repro_torch.core.elasticity_torch`). Every
container in an (N,) fleet gets a discrete resource level
n_i in {min_level..k_levels}. Each epoch the CarbonScaler greedy
allocates levels by marginal carbon efficiency: flatten the (N, K)
table of (marginal work w, marginal grams g) per (container, level),
admit mandatory levels (ramp/floor), then admit optional levels in
descending w/g order while the fleet-wide carbon budget holds.

Work that the allocated capacity cannot serve is *deferred* through a
per-container backlog. Decisions use *estimates* (ĉ, d̂) from
`repro_torch.carbon.forecast`; actual emissions are booked with the
true trace. `ElasticityConfig.forecast` selects "oracle" (truth),
"persistence" (last observation) or "forecast" (diurnal_ar1). With
`shape_budget=True` the fixed per-epoch gram budget becomes a shaped
series (`shaped_budget_series`) that spends more in forecasted-green
hours.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.carbon.forecast import forecast_series

_FORECAST_MODES = ("oracle", "persistence", "forecast")


@dataclass(frozen=True)
class ElasticityConfig:
    """Per-container vertical-scaling knobs (mirrors ReplicaConfig).

    `unit_capacity` is the demand *rate* one level serves (same units
    as the demand trace); `base_w`/`peak_w` are per-level idle/busy
    power. `budget_g_per_epoch` caps fleet-wide estimated grams per
    epoch (None = uncapped: every container gets its desired level).
    """
    k_levels: int = 4
    unit_capacity: float = 1.0
    base_w: float = 50.0
    peak_w: float = 200.0
    min_level: int = 1
    max_step: int = 1
    budget_g_per_epoch: Optional[float] = None
    forecast: str = "persistence"
    rho: float = 0.9
    # shape the fleet budget into forecasted-green hours (same total
    # grams; see shaped_budget_series)
    shape_budget: bool = False
    shape_gamma: float = 2.0

    def __post_init__(self):
        if self.k_levels < 1:
            raise ValueError("k_levels must be >= 1")
        if not (1 <= self.min_level <= self.k_levels):
            raise ValueError("need 1 <= min_level <= k_levels")
        if self.max_step < 1:
            raise ValueError("max_step must be >= 1")
        if self.unit_capacity <= 0:
            raise ValueError("unit_capacity must be > 0")
        if self.peak_w < self.base_w:
            raise ValueError("peak_w must be >= base_w")
        if self.budget_g_per_epoch is not None and self.budget_g_per_epoch < 0:
            raise ValueError("budget_g_per_epoch must be >= 0 or None")
        if self.forecast not in _FORECAST_MODES:
            raise ValueError(f"forecast must be one of {_FORECAST_MODES}")
        if self.shape_gamma <= 0:
            raise ValueError("shape_gamma must be > 0")
        if self.shape_budget and self.budget_g_per_epoch is None:
            raise ValueError("shape_budget needs a budget_g_per_epoch")

    def capw(self, interval_s: float) -> float:
        """Work (demand·s) one level serves in one epoch."""
        return self.unit_capacity * float(interval_s)


def _power_g(levels, served_frac_w, capw, c, cfg: ElasticityConfig,
             interval_s: float):
    """Grams for `levels` serving `served_frac_w` work at intensity c."""
    span = cfg.peak_w - cfg.base_w
    pw = levels * cfg.base_w + span * (served_frac_w / capw)
    return pw * float(interval_s) / 3600.0 * c / 1000.0


def allocate_epoch(want_w, chat, prev, cfg: ElasticityConfig,
                   interval_s: float, budget_g: Optional[float] = None):
    """One epoch of the (N, K) marginal-allocation greedy (NumPy).

    want_w : (N,) estimated work wanted this epoch (demand·dt+backlog)
    chat   : (N,) estimated carbon intensity (g/kWh)
    prev   : (N,) previous levels (float)
    budget_g overrides `cfg.budget_g_per_epoch` for this epoch (budget
    shaping hands each epoch its slice of the fleet budget).
    Returns (n, lo): allocated levels and the mandatory floor, both
    (N,) float64. Uses only (N,)/(N, K) temporaries.
    """
    want_w = np.asarray(want_w, dtype=np.float64)
    chat = np.asarray(chat, dtype=np.float64)
    prev = np.asarray(prev, dtype=np.float64)
    N = want_w.shape[0]
    dt = float(interval_s)
    capw = cfg.capw(dt)
    span = cfg.peak_w - cfg.base_w
    K = cfg.k_levels

    need = np.ceil(want_w / capw)
    lo = np.maximum(float(cfg.min_level), prev - cfg.max_step)
    hi = np.minimum(float(cfg.k_levels), prev + cfg.max_step)
    desired = np.minimum(np.maximum(need, lo), hi)
    budget = cfg.budget_g_per_epoch if budget_g is None else budget_g
    if budget is None:
        return desired, lo

    k_idx = np.arange(1, K + 1, dtype=np.float64)[None, :]
    w = np.clip(want_w[:, None] - (k_idx - 1.0) * capw, 0.0, capw)
    g = ((cfg.base_w + span * (w / capw))
         * dt / 3600.0 * chat[:, None] / 1000.0)
    mand = k_idx <= lo[:, None]
    opt = (k_idx > lo[:, None]) & (k_idx <= desired[:, None])
    mand_flat = np.where(mand, g, 0.0).ravel()
    mand_g = float(np.cumsum(mand_flat)[-1]) if mand_flat.size else 0.0
    # zero-gram guard: free levels sort first, no overflow division
    free = g <= 0.0
    eff = w / np.where(free, 1.0, g)
    score = np.where(opt, np.where(free, -np.inf, -eff), np.inf).ravel()
    order = np.argsort(score, kind="stable")
    gs = np.where(opt, g, 0.0).ravel()[order]
    cum = np.cumsum(gs)
    admit = opt.ravel()[order] & (mand_g + cum <= budget)
    con_of = np.repeat(np.arange(N), K)
    counts = np.bincount(con_of[order[admit]], minlength=N)
    return lo + counts, lo


@dataclass
class ElasticResult:
    levels: np.ndarray          # (T, N) int64 allocated levels
    served_w: np.ndarray        # (T, N) work served per epoch
    offered_w: np.ndarray       # (T, N) work offered (demand·dt)
    backlog: np.ndarray         # (N,) deferred work at the end
    est_emissions_g: float      # grams booked with forecast intensity
    emissions_g: float          # grams booked with the true intensity
    cap_violations: int         # epochs whose *estimated* total > budget
    interval_s: float
    # level-epoch total from an in-scan accumulator when the (T, N)
    # levels stream is not recorded (device layer, record=False)
    level_epochs: Optional[int] = None

    def demand_served(self) -> np.ndarray:
        """Served work back in demand-rate units (feeds the fleet sim)."""
        return self.served_w / float(self.interval_s)

    def summary(self) -> dict:
        offered = float(self.offered_w.sum())
        served = float(self.served_w.sum())
        lev = (self.level_epochs if self.level_epochs is not None
               else int(self.levels.sum()))
        return {
            "elastic_offered_work": offered,
            "elastic_served_work": served,
            "elastic_deferred_work": float(self.backlog.sum()),
            "elastic_served_frac": served / max(offered, 1e-12),
            "elastic_level_epochs": lev,
            "elastic_est_emissions_g": float(self.est_emissions_g),
            "elastic_emissions_g": float(self.emissions_g),
            "elastic_cap_violations": int(self.cap_violations),
        }


def shaped_budget_series(carbon_signal, cfg: ElasticityConfig,
                         interval_s: float) -> np.ndarray:
    """Allocate the fleet gram budget across epochs by forecasted carbon.

    carbon_signal : (T,) fleet-level carbon intensity (e.g. the mean
    over containers, or over the placed fleet's per-container gather).
    Each epoch's share is (window_mean / nowcast)**gamma for the
    config's forecaster — "spend when now looks greener than the rest
    of the coming day" — clipped to [1/4, 4] and renormalized so the
    total equals T·budget_g_per_epoch. Persistence predicts a flat
    signal, so its ratio is identically 1 and the series is uniform:
    the unshaped baseline falls out as a special case rather than a
    separate code path.

    The sweep computes this series once on the host and hands the same
    (T,) floats to the elasticity layer on whichever device it runs.
    """
    if cfg.budget_g_per_epoch is None:
        raise ValueError("shaped_budget_series needs a budget_g_per_epoch")
    sig = np.asarray(carbon_signal, dtype=np.float64)
    if sig.ndim != 1:
        raise ValueError(f"carbon_signal must be (T,); got {sig.shape}")
    T = sig.shape[0]
    period = max(1, int(round(24 * 3600.0 / float(interval_s))))
    fmode = {"oracle": "oracle", "persistence": "persistence",
             "forecast": "diurnal_ar1"}[cfg.forecast]
    from repro_torch.carbon.forecast import window_mean_forecast
    now = forecast_series(sig, fmode, period_steps=period, rho=cfg.rho)
    wmean = window_mean_forecast(sig, fmode, period_steps=period,
                                 rho=cfg.rho)
    share = np.clip((wmean / np.maximum(now, 1e-9)) ** cfg.shape_gamma,
                    0.25, 4.0)
    return cfg.budget_g_per_epoch * T * share / share.sum()


def _forecast_pair(demand, carbon, cfg: ElasticityConfig,
                   interval_s: float):
    """(d̂, ĉ) per the config's mode (see module doc)."""
    period = max(1, int(round(24 * 3600.0 / float(interval_s))))
    dmode = {"oracle": "oracle", "persistence": "persistence",
             "forecast": "diurnal_ar1"}[cfg.forecast]
    cmode = {"oracle": "oracle", "persistence": "persistence",
             "forecast": "diurnal_ar1"}[cfg.forecast]
    dhat = forecast_series(demand, dmode, period_steps=period, rho=cfg.rho)
    chat = forecast_series(carbon, cmode, period_steps=period, rho=cfg.rho)
    return dhat, chat


def simulate_elastic(demand, carbon, cfg: ElasticityConfig,
                     interval_s: float = 300.0, demand_forecast=None,
                     carbon_forecast=None, budget_series=None
                     ) -> ElasticResult:
    """Run the elasticity layer over a (T, N) demand/carbon pair.

    demand : (T, N) demand rate per container
    carbon : (T, N) true carbon intensity per container (g/kWh)
    `demand_forecast`/`carbon_forecast` override the config-derived
    estimates (callers with region-level structure forecast on the
    compact (T, R) matrix and gather — see `repro_torch.core.fleet`).
    `budget_series` overrides the per-epoch budgets; when omitted and
    `cfg.shape_budget` is set, it is derived from the mean-over-
    containers carbon signal via `shaped_budget_series`.
    """
    demand = np.asarray(demand, dtype=np.float64)
    carbon = np.asarray(carbon, dtype=np.float64)
    if demand.shape != carbon.shape or demand.ndim != 2:
        raise ValueError(f"demand {demand.shape} / carbon {carbon.shape} "
                         f"must be equal (T, N)")
    T, N = demand.shape
    dt = float(interval_s)
    capw = cfg.capw(dt)

    dhat = (np.asarray(demand_forecast, dtype=np.float64)
            if demand_forecast is not None else None)
    chat = (np.asarray(carbon_forecast, dtype=np.float64)
            if carbon_forecast is not None else None)
    if dhat is None or chat is None:
        d_auto, c_auto = _forecast_pair(demand, carbon, cfg, dt)
        dhat = d_auto if dhat is None else dhat
        chat = c_auto if chat is None else chat

    levels = np.zeros((T, N), dtype=np.int64)
    served_w = np.zeros((T, N))
    offered_w = demand * dt
    backlog = np.zeros(N, dtype=np.float64)
    prev = np.full(N, float(cfg.min_level))
    est_g = 0.0
    act_g = 0.0
    viol = 0
    if budget_series is not None:
        bud = np.asarray(budget_series, dtype=np.float64)
        if bud.shape != (T,):
            raise ValueError(f"budget_series must be ({T},); "
                             f"got {bud.shape}")
    elif cfg.shape_budget:
        bud = shaped_budget_series(carbon.mean(axis=1), cfg, dt)
    elif cfg.budget_g_per_epoch is not None:
        bud = np.full(T, float(cfg.budget_g_per_epoch))
    else:
        bud = None
    for t in range(T):
        want = dhat[t] * dt + backlog
        budget = None if bud is None else float(bud[t])
        n, lo = allocate_epoch(want, chat[t], prev, cfg, dt, budget_g=budget)
        # estimated grams for what we *planned* to serve, true grams for
        # what actually arrived (demand forecast error shows up here)
        est_w = np.minimum(want, n * capw)
        srv = np.minimum(offered_w[t] + backlog, n * capw)
        backlog = backlog + offered_w[t] - srv
        est_step = float(_power_g(n, est_w, capw, chat[t], cfg, dt).sum())
        est_g += est_step
        act_g += float(_power_g(n, srv, capw, carbon[t], cfg, dt).sum())
        if bud is not None:
            # mandatory levels may exceed the budget on their own; the
            # greedy must never push beyond max(budget, mandatory)
            mand_w = np.minimum(want, lo * capw)
            mand_total = float(_power_g(lo, mand_w, capw, chat[t], cfg,
                                        dt).sum())
            if est_step > max(budget, mand_total) + 1e-9:
                viol += 1
        levels[t] = n.astype(np.int64)
        served_w[t] = srv
        prev = n
    return ElasticResult(levels=levels, served_w=served_w,
                         offered_w=offered_w, backlog=backlog,
                         est_emissions_g=est_g, emissions_g=act_g,
                         cap_violations=viol, interval_s=dt)
