"""The port's Carbon Container controller against the reference's: the
scalar policies (`decide`), their host batch decisions (`decide_batch`),
the plant model and the scalar simulator must give the reference's bits;
the port's fleet on the CPU must equal the port's simulator within 1e-9
with counts exact (the bar of `tests/test_fleet.py`); and a subclassed
stock policy, which the fleet runs through its own `decide_batch` on the
host, must equal the stock kernel within 1e-9 and the reference's
`backend="fleet"` rows within 1e-6."""
import dataclasses

import numpy as np
import pytest

from repro.carbon.intensity import TraceProvider as RefTP
from repro.cluster.slices import paper_family as ref_paper_family
from repro.cluster.slices import tpu_v5e_family as ref_tpu_family
from repro.core import policy as ref_policy
from repro.core.container import ContainerState as RefState
from repro.core.container import PlantModel as RefPlant
from repro.core.simulator import SimConfig as RefSimConfig
from repro.core.simulator import simulate as ref_simulate
from repro.core.spec import SweepSpec as RefSweepSpec
from repro_torch.carbon.intensity import TraceProvider
from repro_torch.cluster.slices import paper_family, tpu_v5e_family
from repro_torch.core import policy
from repro_torch.core.container import (CarbonContainer, ContainerState,
                                        PlantModel)
from repro_torch.core.fleet import FleetSimulatorTorch, _policy_spec
from repro_torch.core.simulator import SimConfig, SimResult, simulate
from repro_torch.core.spec import SweepSpec
from repro_torch.workload.azure_like import sample_population_matrix
from test_torch_reference import engines

FAMILIES = {"paper": (paper_family, ref_paper_family),
            "tpu_v5e": (tpu_v5e_family, ref_tpu_family)}


def _policies(mod):
    """The stock policies of one side, by name."""
    return {
        "cc_energy": lambda: mod.CarbonContainerPolicy("energy"),
        "cc_performance": lambda: mod.CarbonContainerPolicy("performance"),
        "cc_dwell0_margin": lambda: mod.CarbonContainerPolicy(
            "energy", min_dwell=0, idle_margin=0.2),
        "vscale_energy": lambda: mod.VScaleOnlyPolicy("energy"),
        "vscale_performance": lambda: mod.VScaleOnlyPolicy("performance"),
        "agnostic": mod.CarbonAgnosticPolicy,
        "suspend_resume": mod.SuspendResumePolicy,
    }


POLICY_NAMES = sorted(_policies(policy))


def _families(name, unavailable=()):
    fam, ref_fam = (f() for f in FAMILIES[name])
    for j in unavailable:
        fam.available[j] = False
        ref_fam.available[j] = False
    return fam, ref_fam


def _state_grid(n, n_slices, seed):
    """Seeded states: slice, duty, suspended, dwell, a demand window of 0 to
    6 entries, demand, carbon (zero included), target, epsilon."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        window = list(rng.random(int(rng.integers(0, 7))) * 4.0)
        yield dict(
            slice_idx=int(rng.integers(0, n_slices)),
            duty=float(rng.choice([0.0, 0.3, 1.0])),
            suspended=bool(rng.random() < 0.25),
            dwell=int(rng.integers(0, 5)),
            window=window,
            demand=float(rng.choice([0.0, rng.random() * 0.3,
                                     rng.random() * 5.0])),
            c=float(rng.choice([0.0, rng.random() * 800.0])),
            target=float(rng.choice([1.0, 20.0, 45.0, 200.0, 5000.0])),
            eps=float(rng.choice([0.0, 0.05, 0.2])))


def _action(a):
    return (a.kind, a.duty, a.target_slice)


@pytest.mark.parametrize("fam_name,unavailable", [
    ("paper", ()), ("paper", (0,)), ("paper", (1, 3)), ("tpu_v5e", ()),
    ("tpu_v5e", (4,))])
@pytest.mark.parametrize("name", POLICY_NAMES)
def test_decide_equals_the_reference(name, fam_name, unavailable):
    fam, ref_fam = _families(fam_name, unavailable)
    pol, ref_pol = _policies(policy)[name](), _policies(ref_policy)[name]()
    kinds = set()
    for g in _state_grid(400, len(fam), seed=len(unavailable)):
        st, ref_st = (cls(slice_idx=g["slice_idx"], duty=g["duty"],
                          suspended=g["suspended"], dwell=g["dwell"],
                          demand_window=list(g["window"]))
                      for cls in (ContainerState, RefState))
        assert st.recent_peak == ref_st.recent_peak
        args = (g["demand"], g["c"], g["target"], g["eps"])
        got = pol.decide(fam, st, *args)
        want = ref_pol.decide(ref_fam, ref_st, *args)
        assert type(got).__name__ == "Action"
        assert _action(got) == _action(want), (name, g)
        kinds.add(got.kind)
    # the grid reaches more than one branch of every policy
    assert len(kinds) >= 2, kinds


class _BatchState:
    def __init__(self, **arrays):
        self.__dict__.update(arrays)


@pytest.mark.parametrize("fam_name,unavailable", [
    ("paper", ()), ("paper", (1, 3)), ("tpu_v5e", (4,))])
@pytest.mark.parametrize("name", POLICY_NAMES)
def test_decide_batch_equals_the_reference(name, fam_name, unavailable):
    fam, ref_fam = _families(fam_name, unavailable)
    tb, ref_tb = fam.tables(), ref_fam.tables()
    rng = np.random.default_rng(7)
    n = 2_000
    state = _BatchState(
        slice_idx=rng.integers(0, len(fam), n),
        suspended=rng.random(n) < 0.2,
        dwell=rng.integers(0, 5, n),
        recent_peak=rng.random(n) * 4.0)
    demand = np.where(rng.random(n) < 0.1, 0.0, rng.random(n) * 5.0)
    c = np.where(rng.random(n) < 0.05, 0.0, rng.random(n) * 800.0)
    target = rng.choice([1.0, 20.0, 45.0, 200.0], n)
    eps = rng.choice([0.0, 0.05, 0.2], n)
    for budget in (None, policy._budget_batch(target, c, eps)):
        got = _policies(policy)[name]().decide_batch(tb, state, demand, c,
                                                     target, eps,
                                                     budget=budget)
        want = _policies(ref_policy)[name]().decide_batch(
            ref_tb, state, demand, c, target, eps, budget=budget)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert np.array_equal(g, w)
    assert np.array_equal(policy._budget_batch(target, c, eps),
                          ref_policy._budget_batch(target, c, eps))


def test_plant_model_and_power_equal_the_reference():
    fam, ref_fam = _families("paper")
    rng = np.random.default_rng(3)
    for _ in range(500):
        i = int(rng.integers(0, len(fam)))
        duty, demand = rng.random() * 1.4 - 0.2, rng.random() * 5.0
        c = rng.random() * 800.0
        got = PlantModel.run(fam[i], duty, demand, c)
        want = RefPlant.run(ref_fam[i], duty, demand, c)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert PlantModel.idle_power(fam[i]) == RefPlant.idle_power(ref_fam[i])
        assert PlantModel.rate(got.power_w, c) == RefPlant.rate(got.power_w, c)
        w = rng.random() * 1000.0
        assert fam[i].power.util_for_power(w) == \
            ref_fam[i].power.util_for_power(w)
        u = rng.random() * 1.4 - 0.2
        assert fam[i].power.power(u) == ref_fam[i].power.power(u)


def test_carbon_container_object():
    fam = paper_family()
    cc = CarbonContainer(fam, target_rate=45.0)
    assert cc.state.slice_idx == fam.baseline_idx
    assert cc.current_slice is fam[fam.baseline_idx]
    cc.set_target(30.0)
    assert cc.target_rate == 30.0
    cc.state.observe_demand(0.5)
    cc.state.observe_demand(0.2)
    assert cc.state.recent_peak == 0.5


SIM_POLICIES = ("cc_energy", "cc_performance", "vscale_energy", "agnostic",
                "suspend_resume")
RESULT_FIELDS = [f.name for f in dataclasses.fields(SimResult)]


def _obs(kind, T, ref):
    """The observed carbon feed: none, a provider of another region, or a
    per-epoch sequence with dropouts held at the last value."""
    if kind is None:
        return None
    if kind == "provider":
        return (RefTP if ref else TraceProvider).for_region(
            "NL", hours=48, seed=4)
    rng = np.random.default_rng(5)
    seq = RefTP.for_region("PL", hours=48, seed=1).intensity_series(
        np.arange(T) * 300.0) * rng.uniform(0.7, 1.3, T)
    return list(seq)


@pytest.mark.parametrize("obs", [None, "provider", "sequence"])
@pytest.mark.parametrize("region", ["PL", "CAISO"])
@pytest.mark.parametrize("name", SIM_POLICIES)
def test_simulate_equals_the_reference(name, region, obs):
    fam, ref_fam = _families("paper")
    traces = sample_population_matrix(3, days=1, seed=2)
    T = traces.shape[0]
    for k, (target, eps, sgb, srs, record) in enumerate([
            (10.0, 0.05, 1.0, True, True), (45.0, 0.1, 8.0, False, False),
            (80.0, 0.0, 0.25, True, True)]):
        tr = traces[:, k] * (1.0 + k)
        got = simulate(_policies(policy)[name](), fam, tr,
                       TraceProvider.for_region(region, hours=48, seed=1),
                       SimConfig(target, eps, state_gb=sgb,
                                 suspend_releases_slice=srs,
                                 record_series=record),
                       demand_scale=1.5, carbon_obs=_obs(obs, T, False))
        want = ref_simulate(_policies(ref_policy)[name](), ref_fam, tr,
                            RefTP.for_region(region, hours=48, seed=1),
                            RefSimConfig(target, eps, state_gb=sgb,
                                         suspend_releases_slice=srs,
                                         record_series=record),
                            demand_scale=1.5, carbon_obs=_obs(obs, T, True))
        for f in RESULT_FIELDS:
            assert getattr(got, f) == getattr(want, f), f
        assert got.carbon_efficiency == want.carbon_efficiency
        assert (got.series is None) == (not record)


@pytest.mark.parametrize("name", SIM_POLICIES)
def test_fleet_on_cpu_equals_the_ports_simulate(name):
    """N containers in one fleet run against N scalar runs: <= 1e-9, the
    migrations and time on each slice exact."""
    fam = paper_family()
    carbon = TraceProvider.for_region("CAISO", hours=48, seed=1)
    traces = sample_population_matrix(6, days=2, seed=4)
    targets = np.array([10.0, 30.0, 45.0, 60.0, 80.0, 120.0])
    for srs in (True, False):
        res = FleetSimulatorTorch(fam, suspend_releases_slice=srs).run(
            _policies(policy)[name](), traces, carbon, targets, epsilon=0.05,
            state_gb=0.5, device="cpu")
        for i in range(traces.shape[1]):
            want = simulate(_policies(policy)[name](), fam, traces[:, i],
                            carbon, SimConfig(targets[i], 0.05, state_gb=0.5,
                                              suspend_releases_slice=srs))
            for f, got in (("avg_carbon_rate", res.avg_carbon_rate[i]),
                           ("avg_throttle_pct", res.avg_throttle_pct[i]),
                           ("work_done", res.work_done[i]),
                           ("work_demanded", res.work_demanded[i]),
                           ("energy_kwh", res.energy_wh[i] / 1000.0),
                           ("suspended_frac", res.suspended_frac[i]),
                           ("emissions_g", res.emissions_g[i])):
                assert abs(got - getattr(want, f)) <= 1e-9, (f, i, srs)
            assert res.migrations[i] == want.migrations
            el = res.elapsed_s[i]
            tos = {k: v / el for k, v in zip(res.slice_names,
                                               res.time_on_slice_s[i]) if v}
            assert tos == want.time_on_slice


def _subclasses(mod):
    class Agnostic(mod.CarbonAgnosticPolicy):
        pass

    class CC(mod.CarbonContainerPolicy):
        pass

    class SR(mod.SuspendResumePolicy):
        pass
    return {"agnostic": (mod.CarbonAgnosticPolicy, Agnostic),
            "cc_energy": (lambda: mod.CarbonContainerPolicy("energy"),
                          lambda: CC("energy")),
            "cc_performance": (lambda: mod.CarbonContainerPolicy(
                "performance"), lambda: CC("performance")),
            "suspend_resume": (mod.SuspendResumePolicy, SR)}


def _rows_close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in ("migrations_mean", "placement_migrations_mean"):
            if k in a:
                assert a[k] == b[k], k
        assert a["time_on_slice"].keys() == b["time_on_slice"].keys()
    assert got.parity(want) <= tol


@pytest.mark.parametrize("placed", [True, False], ids=["placed", "dense"])
@pytest.mark.parametrize("name", sorted(_subclasses(policy)))
def test_subclassed_policy_runs_its_decide_batch_on_the_host(name, placed):
    """A subclass of a stock policy is not the stock class, so the fleet
    runs its `decide_batch` on the host: its rows equal the stock
    kernel's within 1e-9, and the reference's fleet rows (where the
    subclass also takes the stepping loop) within 1e-6."""
    traces = sample_population_matrix(12, days=1, seed=3)
    stock, sub = _subclasses(policy)[name]
    ref_stock, ref_sub = _subclasses(ref_policy)[name]
    ref_eng, eng = engines(12, capacity=6)
    kw = dict(family=paper_family(), traces=traces, targets=[20.0, 60.0])
    ref_kw = dict(family=ref_paper_family(), traces=traces,
                  targets=[20.0, 60.0])
    if placed:
        kw["placement"], ref_kw["placement"] = eng, ref_eng
    else:
        kw["carbon"] = TraceProvider.for_region("NL", hours=24, seed=1)
        ref_kw["carbon"] = RefTP.for_region("NL", hours=24, seed=1)
    assert _policy_spec(sub())[0] == "host"
    assert _policy_spec(stock())[0] != "host"
    got = SweepSpec(policies={"x": sub}, device="cpu", **kw).run()
    kernel = SweepSpec(policies={"x": stock}, device="cpu", **kw).run()
    _rows_close(got, kernel, 1e-9)
    ref = RefSweepSpec(policies={"x": ref_sub}, backend="fleet",
                       **ref_kw).run()
    _rows_close(got, ref, 1e-6)
    assert RefSweepSpec(policies={"x": ref_stock}, backend="fleet",
                        **ref_kw).run().parity(ref) <= 1e-9


def test_custom_policy_sees_the_references_state():
    """The host state a custom `decide_batch` receives at each epoch is
    the reference's NumPy fleet's: slice, suspended, dwell and the
    rolling demand peak, in the reference's dtypes, and the budget row."""
    seen = {"port": [], "ref": []}

    def recorder(base, key):
        class Rec(base):
            def decide_batch(self, t, state, demand, c, target, eps,
                             budget=None):
                seen[key].append((state.slice_idx.copy(),
                                  state.suspended.copy(), state.dwell.copy(),
                                  np.array(state.recent_peak), demand.copy(),
                                  np.array(c), budget.copy()))
                return super().decide_batch(t, state, demand, c, target,
                                            eps, budget=budget)
        return Rec
    traces = sample_population_matrix(5, days=1, seed=9)
    carbon = TraceProvider.for_region("PL", hours=24, seed=1)
    FleetSimulatorTorch(paper_family()).run(
        recorder(policy.CarbonContainerPolicy, "port")(), traces, carbon,
        30.0, device="cpu")
    from repro.core.fleet import FleetSimulator
    FleetSimulator(ref_paper_family()).run(
        recorder(ref_policy.CarbonContainerPolicy, "ref")(), traces,
        RefTP.for_region("PL", hours=24, seed=1), 30.0)
    assert len(seen["port"]) == len(seen["ref"]) == traces.shape[0]
    for a, b in zip(seen["port"], seen["ref"]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
