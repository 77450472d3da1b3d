"""Causal forecasters for carbon-intensity and demand series.

Host numpy, copied from `repro.carbon.forecast`. The elasticity layer
(`repro_torch.core.elasticity`, `repro_torch.core.elasticity_torch`)
and the degrade ladder (`repro_torch.robustness.degrade`) read these
estimates; `tests/test_torch_host.py` holds the copy bit-equal to the
reference.

  - `persistence(x)`       — last observation carried forward;
  - `ar1_mean(x, rho)`     — causal running mean + AR(1) residual;
  - `diurnal_ar1(x, period_steps, rho)` — online per-slot diurnal
    profile + AR(1) residual;
  - `window_mean_forecast` — the estimate, at each epoch, of the mean
    of the next full period (budget shaping).

The forecast for epoch t reads only x[0..t-1] (epoch 0 uses x[0]).
All clamp predictions at >= 0 and accept (T,) or (T, C) arrays.
Every accumulation is a sequential left fold, so the estimates are the
same floats whichever layer consumes them.
"""
from __future__ import annotations

import numpy as np

_MODES = ("oracle", "persistence", "ar1_mean", "diurnal_ar1")


def _as2d(x):
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        return x[:, None], True
    if x.ndim != 2:
        raise ValueError(f"forecast input must be (T,) or (T, C); "
                         f"got shape {x.shape}")
    return x, False


def persistence(x) -> np.ndarray:
    """x̂_t = x_{t-1} (x̂_0 = x_0): last observation carried forward."""
    x2, squeeze = _as2d(x)
    out = np.empty_like(x2)
    if x2.shape[0]:
        out[0] = x2[0]
        out[1:] = x2[:-1]
    return out[:, 0] if squeeze else out


def ar1_mean(x, rho: float = 0.9) -> np.ndarray:
    """x̂_t = μ_{t-1} + ρ·(x_{t-1} − μ_{t-1}), μ the causal running mean."""
    x2, squeeze = _as2d(x)
    T = x2.shape[0]
    out = np.empty_like(x2)
    run = np.zeros(x2.shape[1], dtype=np.float64)
    for t in range(T):
        if t == 0:
            out[0] = x2[0]
        else:
            mu = run / t
            out[t] = np.maximum(0.0, mu + rho * (x2[t - 1] - mu))
        run = run + x2[t]
    return out[:, 0] if squeeze else out


def diurnal_ar1(x, period_steps: int, rho: float = 0.9) -> np.ndarray:
    """Online per-slot diurnal profile + AR(1) residual (see module doc).

    `period_steps` is the diurnal period in epochs (24*3600/interval_s).
    Slots with no past observation yet fall back to the global running
    mean, so the first cycle degrades gracefully to `ar1_mean`.
    """
    if period_steps < 1:
        raise ValueError("period_steps must be >= 1")
    x2, squeeze = _as2d(x)
    T, C = x2.shape
    out = np.empty_like(x2)
    slot_sum = np.zeros((period_steps, C), dtype=np.float64)
    slot_cnt = np.zeros(period_steps, dtype=np.int64)
    run = np.zeros(C, dtype=np.float64)
    for t in range(T):
        if t == 0:
            out[0] = x2[0]
        else:
            glob = run / t
            s, sp = t % period_steps, (t - 1) % period_steps
            mu_s = slot_sum[s] / slot_cnt[s] if slot_cnt[s] else glob
            mu_sp = slot_sum[sp] / slot_cnt[sp] if slot_cnt[sp] else glob
            out[t] = np.maximum(0.0, mu_s + rho * (x2[t - 1] - mu_sp))
        slot_sum[t % period_steps] += x2[t]
        slot_cnt[t % period_steps] += 1
        run = run + x2[t]
    return out[:, 0] if squeeze else out


def window_mean_forecast(x, mode: str, period_steps: int = 24,
                         rho: float = 0.9) -> np.ndarray:
    """Causal forecast of mean(x[t : t+period_steps]) for a (T,) series.

      - "oracle"       — the true forward-window mean (truncated at the
        end of the series).
      - "persistence"  — x_{t-1}: a flat-signal belief, so the window
        mean *is* the nowcast (x̂_0 = x_0).
      - "ar1_mean"     — the causal running mean μ_{t-1} (the AR term
        decays to μ over the window).
      - "diurnal_ar1"  — the mean of the learned per-slot diurnal
        profile so far (a full window visits every slot once); slots
        not yet observed fall back to the global running mean.

    All modes read only x[0..t-1] except "oracle" (epoch 0 uses x[0]).
    """
    x1 = np.asarray(x, dtype=np.float64)
    if x1.ndim != 1:
        raise ValueError(f"window_mean_forecast input must be (T,); "
                         f"got shape {x1.shape}")
    if period_steps < 1:
        raise ValueError("period_steps must be >= 1")
    T = x1.shape[0]
    out = np.empty(T, dtype=np.float64)
    if mode == "oracle":
        for t in range(T):
            out[t] = x1[t:t + period_steps].mean()
        return out
    if mode == "persistence":
        return persistence(x1)
    if mode == "ar1_mean":
        run = 0.0
        for t in range(T):
            out[t] = x1[0] if t == 0 else run / t
            run += x1[t]
        return np.maximum(0.0, out)
    if mode == "diurnal_ar1":
        slot_sum = np.zeros(period_steps, dtype=np.float64)
        slot_cnt = np.zeros(period_steps, dtype=np.int64)
        run = 0.0
        for t in range(T):
            if t == 0:
                out[0] = x1[0]
            else:
                glob = run / t
                mu = np.where(slot_cnt > 0,
                              slot_sum / np.maximum(slot_cnt, 1), glob)
                out[t] = mu.mean()
            slot_sum[t % period_steps] += x1[t]
            slot_cnt[t % period_steps] += 1
            run += x1[t]
        return np.maximum(0.0, out)
    raise ValueError(f"unknown forecast mode {mode!r}; expected one of "
                     f"{_MODES}")


def forecast_series(x, mode: str, period_steps: int = 24,
                    rho: float = 0.9) -> np.ndarray:
    """Dispatch one of the causal estimators ("oracle" returns x)."""
    if mode == "oracle":
        x2, squeeze = _as2d(x)
        return (x2[:, 0] if squeeze else x2).copy()
    if mode == "persistence":
        return persistence(x)
    if mode == "ar1_mean":
        return ar1_mean(x, rho)
    if mode == "diurnal_ar1":
        return diurnal_ar1(x, period_steps, rho)
    raise ValueError(f"unknown forecast mode {mode!r}; expected one of "
                     f"{_MODES}")
