"""The port's host-side copies must equal the reference's bit for bit:
the port keeps its own copies of these numpy modules, and both sides of
every parity test start from the same traces, tables and costs."""
import numpy as np
import pytest

from repro.carbon.intensity import TraceProvider as RefTP
from repro.carbon.regions import REGIONS as REF_REGIONS
from repro.cluster.migration import MigrationCostModel as RefMig
from repro.cluster.placement import (PlacementConfig as RefPC,
                                     PlacementEngine as RefPE)
from repro.cluster.slices import (paper_family as ref_paper_family,
                                  tpu_v5e_family as ref_tpu_family)
from repro.workload.azure_like import \
    sample_population_matrix as ref_sample_population_matrix
from repro_torch.carbon.intensity import ConstantProvider, TraceProvider
from repro_torch.carbon.regions import REGIONS
from repro_torch.cluster.migration import MigrationCostModel
from repro_torch.cluster.placement import PlacementConfig, PlacementEngine
from repro_torch.cluster.slices import paper_family, tpu_v5e_family
from repro_torch.workload.azure_like import sample_population_matrix


@pytest.mark.parametrize("n,seed,chunk", [(37, 0, 20000), (53, 4, 16)])
def test_sample_population_matrix_is_bit_identical(n, seed, chunk):
    got = sample_population_matrix(n, days=1, seed=seed, chunk=chunk)
    ref = ref_sample_population_matrix(n, days=1, seed=seed, chunk=chunk)
    assert got.shape == ref.shape == (288, n)
    assert np.array_equal(got, ref)


def test_region_table_is_identical():
    assert {k: (v.name, v.avg, v.cov, v.diurnal_phase_h)
            for k, v in REGIONS.items()} == {
        k: (v.name, v.avg, v.cov, v.diurnal_phase_h)
        for k, v in REF_REGIONS.items()}


@pytest.mark.parametrize("region", ["PL", "NL", "CAISO", "SA"])
def test_trace_provider_series_is_bit_identical(region):
    t = np.arange(600) * 300.0
    got = TraceProvider.for_region(region, hours=48, seed=1)
    ref = RefTP.for_region(region, hours=48, seed=1)
    assert np.array_equal(got.intensity_series(t), ref.intensity_series(t))
    assert (ConstantProvider(7.0).intensity_series(t) == 7.0).all()


@pytest.mark.parametrize("policy", ["raise", "interpolate", "hold"])
def test_gap_policy_matches_reference(policy):
    hourly = [300.0, np.nan, 310.0, np.nan, np.nan, 290.0]
    if policy == "raise":
        with pytest.raises(ValueError):
            TraceProvider(hourly)
        return
    got = TraceProvider(hourly, gap_policy=policy).hourly
    assert np.array_equal(got, RefTP(hourly, gap_policy=policy).hourly)


@pytest.mark.parametrize("fam,ref_fam", [(paper_family, ref_paper_family),
                                         (tpu_v5e_family, ref_tpu_family)])
def test_family_tables_are_identical(fam, ref_fam):
    got, ref = fam().tables(), ref_fam().tables()
    for f in ("base_w", "peak_w", "multiple", "bw_gbps", "next_smaller",
              "next_larger"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
        assert getattr(got, f).dtype == getattr(ref, f).dtype, f
    for f in ("smallest", "baseline_idx", "names", "well_formed"):
        assert getattr(got, f) == getattr(ref, f), f
    dev = got.to("cpu")
    assert np.array_equal(dev.base_w.numpy(), ref.base_w)
    assert np.array_equal(dev.next_larger.numpy(), ref.next_larger)


def test_stop_and_copy_time_batch_is_bit_identical():
    rng = np.random.default_rng(0)
    sgb = rng.choice([0.0, 0.25, 1.0, 4.0, 7.5], 64)
    bw = rng.choice([0.0, 0.25, 2.0, 64.0], 64)
    mig = MigrationCostModel(restore_extra_s=1.5)
    ref = RefMig(restore_extra_s=1.5)
    assert np.array_equal(mig.stop_and_copy_time_batch(sgb, bw),
                          ref.stop_and_copy_time_batch(sgb, bw))


@pytest.mark.parametrize("capacity", [None, 9, (10, 6, 8)])
def test_placement_prologue_is_identical(capacity):
    demand = ref_sample_population_matrix(20, days=1, seed=3)
    sgb = np.random.default_rng(2).choice([0.25, 1.0, 4.0], 20)
    regs = ("PL", "NL", "CAISO")
    ref = RefPE(ref_paper_family(),
                [RefTP.for_region(r, hours=24, seed=1) for r in regs],
                config=RefPC(capacity=capacity))._prep(demand, sgb, None)
    got = PlacementEngine(paper_family(),
                          [TraceProvider.for_region(r, hours=24, seed=1)
                           for r in regs],
                          config=PlacementConfig(capacity=capacity))._prep(
        demand, sgb, None)
    for a, b in zip(ref, got):
        if a is None:
            assert b is None
        else:
            assert np.array_equal(a, b)
