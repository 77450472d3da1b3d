"""The port's planner (`plan_torch`) against the reference's `plan_jax`.

At a contended capacity (60% of the fleet per region, all containers
starting round-robin) the plan exercises every admission path: region
assignments must be equal epoch by epoch and migrations exactly, and the
stop-and-copy grams and downtime within 1e-9 relative. The reference
runs both its admission impls: the XLA rendering and the Pallas kernel
in interpret mode.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_torch_reference import engines, jax_reference  # noqa: E402,F401

import repro_torch.cluster.placement as port_placement  # noqa: E402
from repro.workload.azure_like import sample_population_matrix  # noqa: E402
from repro_torch.cluster.placement import plan_torch  # noqa: E402

REL = 1e-9


def _assert_plans_equal(ref, got):
    assert got.assign.shape == ref.assign.shape
    assert np.array_equal(got.assign, ref.assign), "assignments differ"
    assert np.array_equal(got.migrations, ref.migrations)
    assert np.array_equal(got.initial, ref.initial)
    for f in ("overhead_g", "downtime_s"):
        a, b = getattr(ref, f), getattr(got, f)
        assert np.all(np.abs(a - b) <= REL * np.maximum(np.abs(a), 1.0)), f
    assert np.array_equal(got.region_intensity, ref.region_intensity)


@pytest.fixture(scope="module")
def contended():
    n = 500
    demand = sample_population_matrix(n, days=1, seed=2)
    cap = int(np.ceil(0.6 * n))
    return demand, cap


@pytest.mark.parametrize("impl,block_n", [("xla", 8192), ("pallas", 64)])
def test_plan_torch_equals_plan_jax(jax_reference, contended, monkeypatch,
                                    impl, block_n):
    placement_jax, _ = jax_reference
    demand, cap = contended
    ref_eng, eng = engines(demand.shape[1], capacity=cap)
    calls, contended = [], []
    real = port_placement.admission_rounds

    def spy(net, assign, eligible, dst, struck, remaining, rounds):
        out = real(net, assign, eligible, dst, struck, remaining, rounds)
        calls.append(rounds)
        for want in out[2]:                     # each round's wanters
            contended.append(bool((want > remaining).any()))
            remaining = remaining - torch.minimum(want, remaining)
        return out

    monkeypatch.setattr(port_placement, "admission_rounds", spy)
    ref = placement_jax.plan_jax(ref_eng, demand, admission_impl=impl,
                                 block_n=block_n)
    got = plan_torch(eng, demand, device="cpu")
    _assert_plans_equal(ref, got)
    T, R = demand.shape[0], eng.n_regions
    assert calls == [R] * T                     # one call of R rounds an epoch
    assert any(contended), "no admission round was contended"
    assert int((got.occupancy() > cap).sum()) == 0
    assert got.migrations.sum() > 0


@pytest.mark.parametrize("case", ["uncapped", "initial", "state_gb"])
def test_plan_torch_equals_plan_jax_options(jax_reference, case):
    placement_jax, _ = jax_reference
    n = 30
    demand = sample_population_matrix(n, days=1, seed=7)
    kw = {}
    cap = None if case == "uncapped" else 12
    if case == "initial":
        kw["initial"] = np.random.default_rng(1).permutation(
            np.arange(n) % 3)
    if case == "state_gb":
        kw["state_gb"] = np.random.default_rng(5).choice([0.25, 1.0, 4.0], n)
    ref_eng, eng = engines(n, capacity=cap, min_dwell=4)
    ref = placement_jax.plan_jax(ref_eng, demand, **kw)
    got = plan_torch(eng, demand, device="cpu", **kw)
    _assert_plans_equal(ref, got)


@pytest.mark.parametrize("shape", ["N=0", "R=1", "T=0"])
def test_degenerate_shapes(jax_reference, shape):
    placement_jax, _ = jax_reference
    from repro.carbon.intensity import TraceProvider as RefTP
    from repro.cluster.placement import (PlacementConfig as RefPC,
                                         PlacementEngine as RefPE)
    from repro.cluster.slices import paper_family as ref_paper_family
    from repro_torch.carbon.intensity import TraceProvider
    from repro_torch.cluster.placement import PlacementConfig, PlacementEngine
    from repro_torch.cluster.slices import paper_family
    regions = ("PL",) if shape == "R=1" else ("PL", "NL", "CAISO")
    n = 0 if shape == "N=0" else 7
    T = 0 if shape == "T=0" else 288
    demand = sample_population_matrix(max(n, 1), days=1, seed=11)[:T, :n]
    ref_eng = RefPE(ref_paper_family(),
                    [RefTP.for_region(r, hours=24, seed=1) for r in regions],
                    config=RefPC(capacity=8, min_dwell=4))
    eng = PlacementEngine(paper_family(),
                          [TraceProvider.for_region(r, hours=24, seed=1)
                           for r in regions],
                          config=PlacementConfig(capacity=8, min_dwell=4))
    ref = placement_jax.plan_jax(ref_eng, demand)
    got = plan_torch(eng, demand, device="cpu")
    _assert_plans_equal(ref, got)
    assert got.assign.shape == (T, n)
    assert int(got.migrations.sum()) == 0


def test_plan_torch_rejects_bad_inputs():
    _, eng = engines(4, capacity=1)
    with pytest.raises(ValueError, match="capacity"):
        plan_torch(eng, np.ones((5, 4)), device="cpu")
    _, eng = engines(4, capacity=None)
    with pytest.raises(ValueError, match="non-negative"):
        plan_torch(eng, -np.ones((5, 4)), device="cpu")
    with pytest.raises(ValueError, match="device"):
        plan_torch(eng, np.ones((5, 4)), device="meta")
