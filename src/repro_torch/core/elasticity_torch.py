"""The per-container elasticity layer on a device.

`simulate_elastic_torch` runs the (N, K) CarbonScaler greedy of
`repro_torch.core.elasticity` at fleet scale: a Python loop over the T
epochs of float64 tensor ops, with only (N,) and (N·K,) temporaries and
the (T, N) input and served streams. It runs as its own compact-width
epoch loop ahead of the fleet scan, whose demand is its served work.

Carbon comes dense (T, N) or as the placed fleet's ``(region_mat
(T, R), codes (T, N))`` pair, gathered per epoch. Both forecasts are
computed on the host by `repro_torch.carbon.forecast` (carbon on the
(T, R) region matrix when indexed), the same floats the NumPy layer
reads.

Level counts must be exact. The greedy orders levels with a stable
sort, counts admitted levels as integers, and computes what it compares
with `repro_torch.devmath` (`divide`, `ordered_sum`, and `budget_admits`
for the cut): the same bits on the card and on the CPU, and the cut the
NumPy layer's at any fleet size, so a partial sum that lies within
rounding of the budget is decided the same way by all three.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.carbon.forecast import forecast_series
from repro_torch.core.elasticity import (ElasticityConfig, ElasticResult,
                                         shaped_budget_series)
from repro_torch.device import resolve_device
from repro_torch.devmath import divide, ordered_sum
from repro_torch.traffic.sim_torch import greedy_counts

_FMODE = {"oracle": "oracle", "persistence": "persistence",
          "forecast": "diurnal_ar1"}


def _budget_array(budget_series, cfg: ElasticityConfig, dt: float, T: int,
                  signal_fn):
    """(T,) per-epoch budgets (zeros when uncapped, never read then)."""
    if budget_series is not None:
        bud = np.asarray(budget_series, dtype=np.float64)
        if bud.shape != (T,):
            raise ValueError(f"budget_series must be ({T},); "
                             f"got {bud.shape}")
        return bud
    if cfg.budget_g_per_epoch is None:
        return np.zeros(T, dtype=np.float64)
    if cfg.shape_budget:
        return shaped_budget_series(signal_fn(), cfg, dt)
    return np.full(T, float(cfg.budget_g_per_epoch))


def simulate_elastic_torch(demand, carbon, cfg: ElasticityConfig,
                           interval_s: float = 300.0, record: bool = False,
                           budget_series=None, carbon_forecast=None,
                           device="cuda") -> ElasticResult:
    """The elasticity layer over a (T, N) demand on `device`.

    demand : (T, N) demand rate (host array)
    carbon : dense (T, N), or ``(region_mat (T, R), codes (T, N))``
    With `record=False` the (T, N) levels are not kept
    (`ElasticResult.levels` is empty); the level-epoch total still is.
    `budget_series` overrides the per-epoch budgets; when omitted and
    `cfg.shape_budget` is set it is derived from the mean-over-containers
    carbon. `carbon_forecast` overrides the matrix the carbon forecaster
    runs on ((T, R) when indexed, (T, N) dense): the scaler plans on it
    and bills `carbon` (the observed/true split under faults).
    """
    dev = resolve_device(device)
    demand = np.asarray(demand, dtype=np.float64)
    if demand.ndim != 2:
        raise ValueError(f"demand must be (T, N); got {demand.shape}")
    T, n = demand.shape
    dt = float(interval_s)
    period = max(1, int(round(24 * 3600.0 / dt)))
    fmode = _FMODE[cfg.forecast]
    dhat = forecast_series(demand, fmode, period_steps=period, rho=cfg.rho)

    indexed = isinstance(carbon, tuple)
    if indexed:
        region_mat, codes = carbon
        region_mat = np.asarray(region_mat, dtype=np.float64)
        codes = np.asarray(codes)
        if region_mat.ndim != 2 or region_mat.shape[0] != T \
                or codes.shape != (T, n):
            raise ValueError(f"indexed carbon shapes {region_mat.shape} / "
                             f"{codes.shape} do not match demand (T={T}, "
                             f"N={n})")
        fc_src = region_mat
        signal = lambda: region_mat[np.arange(T)[:, None],   # noqa: E731
                                    codes].mean(axis=1)
    else:
        carbon = np.asarray(carbon, dtype=np.float64)
        if carbon.shape != demand.shape:
            raise ValueError(f"carbon {carbon.shape} must match demand "
                             f"{demand.shape}")
        fc_src = carbon
        signal = lambda: carbon.mean(axis=1)                   # noqa: E731
    if carbon_forecast is not None:
        fc = np.asarray(carbon_forecast, dtype=np.float64)
        if fc.shape != fc_src.shape:
            raise ValueError(f"carbon_forecast shape {fc.shape} must match "
                             f"{fc_src.shape}")
        fc_src = fc
    chat_src = forecast_series(fc_src, fmode, period_steps=period,
                               rho=cfg.rho)
    bud = _budget_array(budget_series, cfg, dt, T, signal)

    f64 = dict(dtype=torch.float64, device=dev)
    d_t = torch.as_tensor(demand, **f64)
    dhat_t = torch.as_tensor(dhat, **f64)
    chat_t = torch.as_tensor(chat_src, **f64)
    bud_t = torch.as_tensor(bud, **f64)
    if indexed:
        reg_t = torch.as_tensor(region_mat, **f64)
        codes_t = torch.as_tensor(codes, dtype=torch.int64, device=dev)
    else:
        c_t = torch.as_tensor(carbon, **f64)

    capw = cfg.capw(dt)
    span = cfg.peak_w - cfg.base_w
    budget = cfg.budget_g_per_epoch
    k_idx = torch.arange(1, cfg.k_levels + 1, **f64)[None, :]

    def emis_g(lev, work_w, chat):
        pw = lev * cfg.base_w + span * divide(work_w, capw)
        return ordered_sum(divide(divide(pw * dt, 3600.0) * chat, 1000.0))

    prev = torch.full((n,), float(cfg.min_level), **f64)
    backlog = torch.zeros(n, **f64)
    scal = torch.zeros(4, **f64)       # est_g, act_g, violations, levels
    served = torch.empty((T, n), **f64)
    levels = torch.empty((T, n), dtype=torch.int32, device=dev) \
        if record else None
    for t in range(T):
        if indexed:
            code = codes_t[t]
            c = reg_t[t][code]
            chat = chat_t[t][code]
        else:
            c = c_t[t]
            chat = chat_t[t]
        want = dhat_t[t] * dt + backlog
        need = torch.ceil(divide(want, capw))
        lo = torch.clamp(prev - cfg.max_step, min=float(cfg.min_level))
        hi = torch.clamp(prev + cfg.max_step, max=float(cfg.k_levels))
        desired = torch.minimum(torch.maximum(need, lo), hi)
        if budget is None:
            alloc = desired
        else:
            alloc = lo + greedy_counts(want, chat, lo, desired, k_idx, capw,
                                       cfg.base_w, span, dt, bud_t[t])

        offered = d_t[t] * dt
        est_w = torch.minimum(want, alloc * capw)
        srv = torch.minimum(offered + backlog, alloc * capw)
        backlog = backlog + offered - srv
        est_step = emis_g(alloc, est_w, chat)
        act_step = emis_g(alloc, srv, c)
        if budget is None:
            viol = torch.zeros((), **f64)
        else:
            mand_w = torch.minimum(want, lo * capw)
            mand_total = emis_g(lo, mand_w, chat)
            viol = (est_step > torch.maximum(bud_t[t], mand_total)
                    + 1e-9).double()
        scal = scal + torch.stack([est_step, act_step, viol,
                                   ordered_sum(alloc)])
        served[t] = divide(srv, dt)
        if record:
            levels[t] = alloc.int()
        prev = alloc

    scal = scal.cpu().numpy()
    return ElasticResult(
        levels=(levels.cpu().numpy().astype(np.int64) if record
                else np.zeros((0, n), dtype=np.int64)),
        served_w=served.cpu().numpy() * dt, offered_w=demand * dt,
        backlog=backlog.cpu().numpy(),
        est_emissions_g=float(scal[0]), emissions_g=float(scal[1]),
        cap_violations=int(round(float(scal[2]))), interval_s=dt,
        level_epochs=int(round(float(scal[3]))))
