"""The port's fleet scan (`FleetSimulatorTorch`) against the reference's
`FleetSimulatorJax`, on the cases of `tests/test_fleet_jax.py`.

Floats must agree within 1e-6 relative (both sides accumulate raw sums
and scale once after the loop, so they agree to rounding); migrations
and time on each slice are counts and must be equal. Every fleet carries
a zero-demand column and a budget-exhausted (tiny-target) column.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_reference import REGIONS, jax_reference  # noqa: E402,F401

from repro.carbon.intensity import TraceProvider as RefTP  # noqa: E402
from repro.cluster.slices import (paper_family as ref_paper_family,  # noqa: E402
                                  tpu_v5e_family as ref_tpu_family)
from repro.core import policy as ref_policy  # noqa: E402
from repro.workload.azure_like import sample_population  # noqa: E402
from repro_torch.carbon.intensity import TraceProvider  # noqa: E402
from repro_torch.cluster.slices import paper_family, tpu_v5e_family  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.core.fleet import FleetSimulatorTorch  # noqa: E402

REL = 1e-6
FIELDS = ("emissions_g", "energy_wh", "work_done", "work_demanded",
          "throttled_integral", "suspended_s", "elapsed_s")


def _policies(mod):
    return {
        "carbon_agnostic": mod.CarbonAgnosticPolicy,
        "suspend_resume": mod.SuspendResumePolicy,
        "vscale_only": lambda: mod.VScaleOnlyPolicy(),
        "cc_energy": lambda: mod.CarbonContainerPolicy("energy"),
        "cc_performance": lambda: mod.CarbonContainerPolicy("performance"),
    }


def _fleet_inputs(n=6, seed=2):
    traces = [t.util for t in sample_population(n, days=1, seed=seed)]
    demand = np.stack(traces, axis=1)
    demand[:, 0] = 0.0                          # zero-demand edge case
    targets = np.linspace(10.0, 80.0, n)
    targets[1] = 1e-6                           # budget exhaustion edge case
    sgb = (np.arange(n) % 4 + 1) * 0.5
    return demand, targets, sgb


def _close(a, b):
    return np.all(np.abs(a - b) <= REL * np.maximum(np.abs(a), 1.0))


def _assert_close(ref, got, ctx=""):
    for f in FIELDS:
        assert _close(getattr(ref, f), getattr(got, f)), f"{ctx}: {f}"
    assert np.array_equal(ref.migrations, got.migrations), ctx
    assert np.array_equal(ref.time_on_slice_s, got.time_on_slice_s), ctx
    assert ref.slice_names == got.slice_names
    assert ref.baseline_cap == got.baseline_cap


@pytest.mark.parametrize("name", sorted(_policies(policy)))
def test_torch_matches_jax_per_policy(jax_reference, name):
    _, fleet_jax = jax_reference
    demand, targets, sgb = _fleet_inputs()
    ref = fleet_jax.FleetSimulatorJax(ref_paper_family()).run(
        _policies(ref_policy)[name](), demand,
        RefTP.for_region("CAISO", hours=24, seed=1), targets, state_gb=sgb)
    got = FleetSimulatorTorch(paper_family()).run(
        _policies(policy)[name](), demand,
        TraceProvider.for_region("CAISO", hours=24, seed=1), targets,
        state_gb=sgb, device="cpu")
    _assert_close(ref, got, name)


def test_torch_matches_jax_hold_slice_mixed_regions(jax_reference):
    """suspend_releases_slice=False + a (T, N) per-container carbon
    matrix (mixed-region fleet) + the TPU family in one run."""
    _, fleet_jax = jax_reference
    demand, targets, sgb = _fleet_inputs(n=4)
    tvec = np.arange(demand.shape[0]) * 300.0
    provs = [RefTP.for_region(r, hours=24, seed=1) for r in REGIONS]
    cmat = np.stack([provs[i % 3].intensity_series(tvec) for i in range(4)],
                    axis=1)
    targets = targets * 40.0
    ref = fleet_jax.FleetSimulatorJax(
        ref_tpu_family(), suspend_releases_slice=False).run(
        ref_policy.CarbonContainerPolicy("energy"), demand, cmat, targets,
        state_gb=sgb)
    got = FleetSimulatorTorch(
        tpu_v5e_family(), suspend_releases_slice=False).run(
        policy.CarbonContainerPolicy("energy"), demand, cmat, targets,
        state_gb=sgb, device="cpu")
    _assert_close(ref, got, "hold-slice mixed-region tpu")


@pytest.mark.parametrize("name", ["cc_energy", "suspend_resume"])
def test_torch_matches_jax_indexed_carbon(jax_reference, name):
    """The placed form: compact demand, (region_mat, codes) carbon and
    n_rep target replicas of every column."""
    _, fleet_jax = jax_reference
    demand, _, _ = _fleet_inputs(n=5, seed=4)
    T, n_cols = demand.shape
    rng = np.random.default_rng(3)
    tvec = np.arange(T) * 300.0
    region_mat = np.stack([RefTP.for_region(r, hours=24, seed=1)
                           .intensity_series(tvec) for r in REGIONS], axis=1)
    codes = rng.integers(0, 3, (T, n_cols)).astype(np.int32)
    n_rep = 3
    targets = np.repeat([15.0, 40.0, 70.0], n_cols)
    sgb = rng.choice([0.25, 1.0, 4.0], n_rep * n_cols)
    ref = fleet_jax.FleetSimulatorJax(ref_paper_family()).run(
        _policies(ref_policy)[name](), demand, (region_mat, codes), targets,
        state_gb=sgb, n_rep=n_rep)
    got = FleetSimulatorTorch(paper_family()).run(
        _policies(policy)[name](), demand, (region_mat, codes), targets,
        state_gb=sgb, n_rep=n_rep, device="cpu")
    assert got.emissions_g.shape == (n_rep * n_cols,)
    _assert_close(ref, got, f"indexed {name}")


def test_torch_record_series_matches_and_conserves(jax_reference):
    _, fleet_jax = jax_reference
    demand, targets, sgb = _fleet_inputs(n=4)
    ref = fleet_jax.FleetSimulatorJax(ref_paper_family()).run(
        ref_policy.CarbonContainerPolicy("energy"), demand,
        RefTP.for_region("CAISO", hours=24, seed=1), targets, state_gb=sgb,
        record=True)
    got = FleetSimulatorTorch(paper_family()).run(
        policy.CarbonContainerPolicy("energy"), demand,
        TraceProvider.for_region("CAISO", hours=24, seed=1), targets,
        state_gb=sgb, record=True, device="cpu")
    assert got.power_series.shape == ref.power_series.shape
    assert _close(ref.power_series, got.power_series)
    assert _close(ref.served_series, got.served_series)
    assert (got.served_series >= 0.0).all()
    assert np.allclose(got.work_done + got.throttled_integral,
                       got.work_demanded, rtol=1e-9, atol=1e-6)


def test_torch_fleet_rejects_what_is_not_ported():
    class Custom(policy.CarbonContainerPolicy):
        pass

    sim = FleetSimulatorTorch(paper_family())
    carbon = TraceProvider.for_region("PL", hours=24, seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.run(Custom(), np.ones((4, 2)), carbon, 45.0, device="cpu")
    for kw in ("traffic", "energy", "carbon_obs", "power_gap"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sim.run(policy.CarbonAgnosticPolicy(), np.ones((4, 2)), carbon,
                    45.0, device="cpu", **{kw: object()})
    with pytest.raises(ValueError, match="non-negative"):
        sim.run(policy.CarbonAgnosticPolicy(), np.array([[0.5], [-0.1]]),
                carbon, 45.0, device="cpu")
    with pytest.raises(ValueError, match="carbon matrix shape"):
        sim.run(policy.CarbonAgnosticPolicy(), np.ones((4, 2)),
                np.ones((3, 2)), 45.0, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        sim.run(policy.CarbonAgnosticPolicy(), np.ones((4, 2)),
                (np.ones((4, 3)), np.full((4, 2), 3)), 45.0, device="cpu")
