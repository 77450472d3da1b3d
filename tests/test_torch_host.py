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
from repro.workload.azure_like import sample_population as ref_sample_population
from repro.workload.azure_like import \
    sample_population_matrix as ref_sample_population_matrix
from repro_torch.carbon.intensity import ConstantProvider, TraceProvider
from repro_torch.carbon.regions import REGIONS
from repro_torch.cluster.migration import MigrationCostModel
from repro_torch.cluster.placement import PlacementConfig, PlacementEngine
from repro_torch.cluster.slices import paper_family, tpu_v5e_family
from repro_torch.workload.azure_like import (sample_population,
                                             sample_population_matrix)


@pytest.mark.parametrize("n,seed,chunk", [(37, 0, 20000), (53, 4, 16)])
def test_sample_population_matrix_is_bit_identical(n, seed, chunk):
    got = sample_population_matrix(n, days=1, seed=seed, chunk=chunk)
    ref = ref_sample_population_matrix(n, days=1, seed=seed, chunk=chunk)
    assert got.shape == ref.shape == (288, n)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("n,days,seed", [(7, 1, 2), (4, 3, 5)])
def test_sample_population_is_bit_identical(n, days, seed):
    got = sample_population(n, days=days, seed=seed)
    ref = ref_sample_population(n, days=days, seed=seed)
    assert len(got) == len(ref) == n
    for a, b in zip(got, ref):
        assert np.array_equal(a.util, b.util)
        assert (a.target_mean, a.target_cov, a.mean, a.cov) == (
            b.target_mean, b.target_cov, b.mean, b.cov)


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


# --- the layers' host copies: forecast, robustness, traffic, energy,
# --- elasticity (each held bit-equal to the reference module)

def _eq(a, b):
    """Bit-equal values, recursing through dataclass fields and tuples."""
    if hasattr(a, "__dataclass_fields__"):
        return all(_eq(getattr(a, f), getattr(b, f))
                   for f in a.__dataclass_fields__)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    return a == b


def _carbon(T=300, R=3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    return (260.0 + 180.0 * np.sin(2 * np.pi * t / 288.0
                                   + np.linspace(0, 2, R))
            + rng.normal(0.0, 20.0, (T, R)))


@pytest.mark.parametrize("mode", ["oracle", "persistence", "ar1_mean",
                                  "diurnal_ar1"])
def test_forecasts_are_bit_identical(mode):
    from repro.carbon import forecast as ref
    from repro_torch.carbon import forecast as got
    x = _carbon()
    assert _eq(got.forecast_series(x, mode, period_steps=288, rho=0.8),
               ref.forecast_series(x, mode, period_steps=288, rho=0.8))
    assert _eq(got.window_mean_forecast(x[:, 0], mode, period_steps=24),
               ref.window_mean_forecast(x[:, 0], mode, period_steps=24))


def _fault_plans(ref_mod, mod, mode):
    def make(m):
        return m.FaultPlan(
            carbon=m.CarbonFeedFaults(dropout_prob=0.2, stale_every=2,
                                      blackouts=((-1, 100, 30), (1, 10, 5)),
                                      noise_windows=((2, 50, 20, 0.3),)),
            power=m.PowerTelemetryFaults(gap_prob=0.1, gaps=((5, 4),)),
            migration=m.MigrationFaults(fail_prob=0.3, backoff_cap=8),
            degrade=m.DegradeConfig(mode=mode, ttl_epochs=3,
                                    prior_ttl_epochs=40), seed=5)
    return make(ref_mod), make(mod)


@pytest.mark.parametrize("mode", ["ladder", "hold", "conservative"])
def test_fault_masks_and_observed_signal_are_bit_identical(mode):
    from repro import robustness as ref_rob
    from repro_torch import robustness as rob
    assert sorted(rob.__all__) == sorted(ref_rob.__all__)
    ref_plan, plan = _fault_plans(ref_rob, rob, mode)
    assert _eq(rob.carbon_fault_masks(plan, 300, 3),
               ref_rob.carbon_fault_masks(ref_plan, 300, 3))
    assert _eq(rob.migration_failure_mask(plan, 300, 7),
               ref_rob.migration_failure_mask(ref_plan, 300, 7))
    assert _eq(rob.power_gap_vector(plan, 300),
               ref_rob.power_gap_vector(ref_plan, 300))
    got = rob.observe_intensity(_carbon(), plan, 300.0)
    want = ref_rob.observe_intensity(_carbon(), ref_plan, 300.0)
    assert _eq(got, want) and got.summary() == want.summary()
    power = np.random.default_rng(1).uniform(50.0, 300.0, (300, 3))
    assert rob.budget_violations(power, got.true, [40.0] * 3, 300.0) == \
        ref_rob.budget_violations(power, want.true, [40.0] * 3, 300.0)


def _traffic_configs(budget, policy="carbon", spill=True):
    from repro import traffic as ref_tr
    from repro.traffic.autoscale import ReplicaConfig as RefRC
    from repro_torch import traffic as tr
    from repro_torch.traffic.autoscale import ReplicaConfig

    def make(m, rc):
        return m.TrafficConfig(
            population=m.UserPopulation(n_users=5000, n_regions=3, seed=2),
            routing=m.RoutingConfig(policy=policy, spill=spill),
            replicas=rc(throughput_rps=0.1, max_replicas=8, max_step=2,
                        budget_g_per_epoch=budget))
    return make(ref_tr, RefRC), make(tr, ReplicaConfig)


@pytest.mark.parametrize("budget,policy,spill", [(None, "carbon", True),
                                                 (25.0, "latency", False)])
def test_traffic_pipeline_is_bit_identical(budget, policy, spill):
    from repro import traffic as ref_tr
    from repro_torch import traffic as tr
    ref_cfg, cfg = _traffic_configs(budget, policy, spill)
    want_arr = ref_tr.request_matrix(ref_cfg.population, 96, 300.0)
    got_arr = tr.request_matrix(cfg.population, 96, 300.0)
    assert _eq(got_arr, want_arr)
    carbon = _carbon(96)
    carbon[7] = 0.0                      # zero-gram epoch
    lat = cfg.latency_matrix()
    assert _eq(lat, ref_cfg.latency_matrix())
    assert _eq(tr.route(got_arr.requests, 3000.0, carbon, lat, cfg.routing),
               ref_tr.route(want_arr.requests, 3000.0, carbon, lat,
                            ref_cfg.routing))
    assert _eq(tr.autoscale(got_arr.requests, carbon, cfg.replicas),
               ref_tr.autoscale(want_arr.requests, carbon, ref_cfg.replicas))
    got = tr.simulate_traffic(got_arr.requests, carbon, cfg)
    want = ref_tr.simulate_traffic(want_arr.requests, carbon, ref_cfg)
    assert _eq(got, want) and got.summary() == want.summary()
    assert _eq(got.demand_mod(0.7), want.demand_mod(0.7))


def test_energy_supply_is_bit_identical():
    from repro import energy as ref_en
    from repro.energy.supply import flex_w_per_unit as ref_flex
    from repro_torch import energy as en
    from repro_torch.energy.supply import flex_w_per_unit
    assert flex_w_per_unit(paper_family()) == ref_flex(ref_paper_family())
    events = dict(outages=((1, 20, 6),), shocks=((-1, 50, 12, 2.0),),
                  n_random_outages=2, n_random_shocks=2, seed=4)
    assert _eq(en.event_matrices(en.GridEventConfig(**events), 200, 3),
               ref_en.event_matrices(ref_en.GridEventConfig(**events), 200,
                                     3))
    cfg, ref_cfg = en.EnergyConfig(), ref_en.EnergyConfig()
    spec = en.EnergySpec.from_config(cfg, 40, 3, 300.0, 2.0)
    assert tuple(spec) == tuple(ref_en.EnergySpec.from_config(
        ref_cfg, 40, 3, 300.0, 2.0))
    solar = en.solar_series(cfg.solar, 200, 3, 300.0, spec.solar_peak_w)
    assert _eq(solar, ref_en.solar_series(ref_cfg.solar, 200, 3, 300.0,
                                          spec.solar_peak_w))
    rng = np.random.default_rng(3)
    load = rng.uniform(0.0, 4000.0, (200, 3))
    up = (rng.random((200, 3)) > 0.1).astype(float)
    grid_c = _carbon(200)
    got = en.simulate_supply(load, solar, grid_c, up, spec)
    want = ref_en.simulate_supply(load, solar, grid_c, up, spec)
    assert _eq({k: getattr(got, k) for k in got.__dataclass_fields__
                if k != "spec"},
               {k: getattr(want, k) for k in want.__dataclass_fields__
                if k != "spec"})
    assert got.summary() == want.summary()
    soc = np.full(3, spec.soc0_wh)
    assert _eq(en.supply_step_np(spec, soc, load[0], solar[0], grid_c[0],
                                 up[0]),
               ref_en.supply_step_np(spec, soc, load[0], solar[0],
                                     grid_c[0], up[0]))


@pytest.mark.parametrize("budget,shape", [(None, False), (2.0, True)])
def test_elasticity_layer_is_bit_identical(budget, shape):
    from repro.core import elasticity as ref_el
    from repro_torch.core import elasticity as el
    kw = dict(k_levels=4, unit_capacity=1.5, budget_g_per_epoch=budget,
              forecast="forecast", shape_budget=shape)
    rng = np.random.default_rng(0)
    demand = np.abs(rng.normal(3.0, 1.5, (48, 12)))
    carbon = np.abs(rng.normal(300.0, 150.0, (48, 12)))
    carbon[5] = 0.0
    want = ref_el.simulate_elastic(demand, carbon, ref_el.ElasticityConfig(
        **kw), 300.0)
    got = el.simulate_elastic(demand, carbon, el.ElasticityConfig(**kw),
                              300.0)
    assert _eq(got, want) and got.summary() == want.summary()
    assert _eq(el.allocate_epoch(demand[3] * 300.0, carbon[3],
                                 np.full(12, 2.0), el.ElasticityConfig(**kw),
                                 300.0, budget_g=1.0),
               ref_el.allocate_epoch(demand[3] * 300.0, carbon[3],
                                     np.full(12, 2.0),
                                     ref_el.ElasticityConfig(**kw), 300.0,
                                     budget_g=1.0))
    if budget is not None:
        assert _eq(el.shaped_budget_series(carbon.mean(axis=1),
                                           el.ElasticityConfig(**kw), 300.0),
                   ref_el.shaped_budget_series(carbon.mean(axis=1),
                                               ref_el.ElasticityConfig(**kw),
                                               300.0))


def test_power_model_is_bit_identical():
    from repro.power.model import LinearPowerModel as RefLPM
    from repro.power.model import calibrate_linear as ref_calibrate
    from repro.power.model import component_power_sweep as ref_sweep
    from repro_torch.power.model import (LinearPowerModel, calibrate_linear,
                                         component_power_sweep)
    rng = np.random.default_rng(2)
    for base, peak in ((100.0, 200.0), (25.0, 50.0), (80.0, 80.0),
                       (90.0, 60.0)):
        m, ref = LinearPowerModel(base, peak), RefLPM(base, peak)
        for x in np.concatenate([rng.random(50) * 1.6 - 0.3,
                                 rng.random(50) * 300.0, [base, peak]]):
            assert m.power(float(x)) == ref.power(float(x))
            assert m.util_for_power(float(x)) == ref.util_for_power(float(x))
        if peak >= base:
            assert component_power_sweep(m, seed=3) == ref_sweep(ref, seed=3)
    u = rng.random(40)
    w = 100.0 + 100.0 * u + rng.normal(0.0, 2.0, 40)
    got, r2 = calibrate_linear(u, w)
    want, ref_r2 = ref_calibrate(u, w)
    assert (got.base_w, got.peak_w, r2) == (want.base_w, want.peak_w, ref_r2)


@pytest.mark.parametrize("region", ["PL", "CAISO"])
def test_scalar_intensity_and_trace_cov_are_bit_identical(region):
    from repro.carbon.intensity import ConstantProvider as RefCP
    from repro.carbon.traces import synth_trace as ref_synth
    from repro.carbon.traces import trace_cov as ref_cov
    from repro_torch.carbon.traces import trace_cov
    got = TraceProvider(TraceProvider.for_region(region, hours=30,
                                                 seed=2).hourly, start_s=90.0)
    ref = RefTP(RefTP.for_region(region, hours=30, seed=2).hourly,
                start_s=90.0)
    for t in np.concatenate([np.arange(0, 200_000, 299.0), [-4000.0]]):
        assert got.intensity(float(t)) == ref.intensity(float(t))
        assert type(got.intensity(float(t))) is float
    assert ConstantProvider(7.5).intensity(3.0) == RefCP(7.5).intensity(3.0)
    trace = ref_synth(region, 24 * 7, seed=4)
    assert trace_cov(trace) == ref_cov(trace)


@pytest.mark.parametrize("fam,ref_fam", [(paper_family, ref_paper_family),
                                         (tpu_v5e_family, ref_tpu_family)])
def test_slice_family_protocol_is_identical(fam, ref_fam):
    got, ref = fam(), ref_fam()
    assert len(got) == len(ref)
    for i in range(len(got)):
        a, b = got[i], ref[i]
        assert (a.name, a.multiple, a.capacity(), a.chips, a.state_bw_gbps,
                a.power.base_w, a.power.peak_w) == (
            b.name, b.multiple, b.capacity(), b.chips, b.state_bw_gbps,
            b.power.base_w, b.power.peak_w)
    assert got.baseline.name == ref.baseline.name
    got.available[0] = ref.available[0] = False
    assert [got.next_smaller(i) for i in range(len(got))] == [
        ref.next_smaller(i) for i in range(len(ref))]
    assert got.smallest() == ref.smallest()


def test_scalar_stop_and_copy_time_is_bit_identical():
    mig, ref = MigrationCostModel(restore_extra_s=1.5), RefMig(
        restore_extra_s=1.5)
    for sgb in (0.0, 0.25, 1.0, 7.5):
        assert mig.suspend_time(sgb) == ref.suspend_time(sgb)
        assert mig.resume_time(sgb) == ref.resume_time(sgb)
        for bw in (0.0, 0.25, 2.0, 64.0):
            for comp in (True, False):
                assert mig.stop_and_copy_time(
                    sgb, compressed=comp, transfer_gbps=bw) == \
                    ref.stop_and_copy_time(sgb, compressed=comp,
                                           transfer_gbps=bw)
