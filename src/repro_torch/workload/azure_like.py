"""Synthetic VM utilization population matched to the Azure trace analysis.

Host numpy, copied from `repro.workload.azure_like` (the vectorized
matrix generator only). The draw order is part of the contract: the
same seed gives bit-identical (T, n_vms) matrices on both sides.
"""
from __future__ import annotations

import numpy as np

INTERVAL_S = 300.0   # 5-minute readings, as in the Azure trace

# CoV bucket mixture (fractions sum to 1): [lo, hi): prob
_COV_BUCKETS = [
    ((0.02, 0.25), 0.08),
    ((0.25, 0.40), 0.42),
    ((0.40, 1.00), 0.20),
    ((1.00, 2.50), 0.30),
]


def _draw_targets_matrix(rng, n):
    """Per-VM (mean, CoV) targets: lognormal means with ~43% below 0.10,
    CoV drawn from the bucket mixture."""
    means = np.clip(np.exp(rng.normal(np.log(0.13), 1.0, n)), 0.005, 0.9)
    edges = np.cumsum([p for _, p in _COV_BUCKETS])
    b = np.minimum(np.searchsorted(edges, rng.random(n), side="left"),
                   len(_COV_BUCKETS) - 1)
    lo = np.array([rng_lo for (rng_lo, _), _ in _COV_BUCKETS])[b]
    hi = np.array([rng_hi for (_, rng_hi), _ in _COV_BUCKETS])[b]
    return means, rng.uniform(lo, hi)


def ar1_burst_factors(rng, T: int, sigma, rho: float = 0.97) -> np.ndarray:
    """(T, n) multiplicative log-AR(1) + Poisson-burst factors, mean ~1.
    Draw order: normal block, burst counts, starts, lens, amps."""
    sigma = np.asarray(sigma, dtype=np.float64)
    n = sigma.size
    sig_eps = sigma * np.sqrt(1 - rho ** 2)
    eps = rng.normal(0.0, 1.0, (T, n)) * sig_eps
    x = np.zeros((T, n))
    for i in range(1, T):
        x[i] = rho * x[i - 1] + eps[i]
    counts = rng.poisson(T / 600, n)
    tot = int(counts.sum())
    vm = np.repeat(np.arange(n), counts)
    starts = rng.integers(0, T, tot)
    lens = rng.integers(3, 24, tot)
    amps = rng.uniform(1.0, 3.0, tot) * sigma[vm]
    bd = np.zeros((T + 1, n))
    np.add.at(bd, (starts, vm), amps)
    np.add.at(bd, (np.minimum(starts + lens, T), vm), -amps)
    burst = np.cumsum(bd[:-1], axis=0)
    return np.exp(x - 0.5 * sigma ** 2 + burst)


def _gen_series_block(rng, T, means, covs):
    """(T, n) block of AR(1)+burst series, rescaled by a short
    fixed-point loop so the clipped series hit their target means."""
    n = means.size
    sigma = np.maximum(covs, 0.02)
    scale = np.ones(n)
    out = np.empty((T, n))
    done = np.zeros(n, dtype=bool)
    for _ in range(4):
        factors = ar1_burst_factors(rng, T, sigma)
        series = np.clip(means * scale * factors, 0.0, 1.0)
        fresh = ~done
        out[:, fresh] = series[:, fresh]
        got = series.mean(axis=0)
        done |= np.abs(got - means) / np.maximum(means, 1e-9) < 0.05
        if done.all():
            break
        scale = np.where(done, scale,
                         scale * means / np.maximum(got, 1e-9))
    return out


def sample_population_matrix(n_vms: int = 1000, days: int = 7,
                             seed: int = 0,
                             chunk: int = 20000) -> np.ndarray:
    """(T, n_vms) demand matrix at 5-minute epochs, generated in VM
    chunks so peak scratch stays a few (T, chunk) arrays."""
    rng = np.random.default_rng(seed)
    T = int(days * 24 * 3600 / INTERVAL_S)
    out = np.empty((T, n_vms))
    for lo in range(0, n_vms, chunk):
        hi = min(lo + chunk, n_vms)
        means, covs = _draw_targets_matrix(rng, hi - lo)
        out[:, lo:hi] = _gen_series_block(rng, T, means, covs)
    return out
