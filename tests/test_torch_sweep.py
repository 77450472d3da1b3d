"""The slice as a whole: the port's placed population sweep against the
reference's, and a plan carried across from the reference.

`SweepSpec(backend="torch", device="cpu")` must reproduce the reference
`SweepSpec(backend="jax")` rows within 1e-6 (`SweepResult.parity`), with
container and placement migrations equal.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_reference import REGIONS, engines, jax_reference  # noqa: E402,F401

from repro.carbon.intensity import TraceProvider as RefTP  # noqa: E402
from repro.cluster.slices import paper_family as ref_paper_family  # noqa: E402
from repro.core import policy as ref_policy  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.core.spec import SweepSpec as RefSweepSpec  # noqa: E402
from repro.workload.azure_like import sample_population_matrix  # noqa: E402
from repro_torch.carbon.intensity import TraceProvider  # noqa: E402
from repro_torch.cluster.placement import PlacementConfig  # noqa: E402
from repro_torch.cluster.slices import paper_family  # noqa: E402
from repro_torch.convert import from_reference_arrays  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.core.fleet import (FleetSimulatorTorch,  # noqa: E402
                                    _aggregate_sweep_rows)
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.core.spec import SweepSpec  # noqa: E402

TOL = 1e-6
TARGETS = [20.0, 40.0, 60.0, 80.0]


def _pols(mod):
    return {"carbon_containers": lambda: mod.CarbonContainerPolicy("energy"),
            "suspend_resume": mod.SuspendResumePolicy}


@pytest.fixture(scope="module")
def placed():
    n = 500
    return sample_population_matrix(n, days=1, seed=2), int(np.ceil(0.6 * n))


def _assert_rows_match(ref, got):
    assert got.backend == "torch"
    assert len(got) == len(ref)
    # the same row keys: `parity` compares only the keys both results have
    assert [set(b) for b in got.rows] == [set(a) for a in ref.rows]
    assert got.parity(ref) <= TOL
    for a, b in zip(ref.rows, got.rows):
        assert (a["policy"], a["target"]) == (b["policy"], b["target"])
        for k in ("migrations_mean", "placement_migrations_mean"):
            if k in a:
                assert a[k] == b[k], k
        for k in set(a["time_on_slice"]) | set(b["time_on_slice"]):
            assert abs(a["time_on_slice"].get(k, 0.0)
                       - b["time_on_slice"].get(k, 0.0)) <= TOL


def test_placed_sweep_matches_reference(jax_reference, placed):
    demand, cap = placed
    ref_eng, eng = engines(demand.shape[1], capacity=cap)
    ref = RefSweepSpec(_pols(ref_policy), ref_paper_family(), demand,
                       TARGETS, backend="jax", placement=ref_eng).run()
    got = SweepSpec(_pols(policy), paper_family(), demand, TARGETS,
                    placement=eng, device="cpu").run()
    _assert_rows_match(ref, got)
    assert got.rows[0]["placement_migrations_mean"] > 0


def test_placement_config_pair_matches_reference(jax_reference):
    """placement=(PlacementConfig, regions), demand_scale and a custom
    SimConfig go through the same path."""
    demand = sample_population_matrix(40, days=1, seed=6)
    kw = dict(demand_scale=1.3)
    ref_cfg = RefSimConfig(target_rate=0.0, epsilon=0.1, state_gb=2.0)
    cfg = SimConfig(target_rate=0.0, epsilon=0.1, state_gb=2.0)
    from repro.cluster.placement import PlacementConfig as RefPC
    ref = RefSweepSpec(
        _pols(ref_policy), ref_paper_family(), demand, TARGETS[:2],
        sim=ref_cfg, backend="jax", placement=RefPC(capacity=20, min_dwell=3),
        regions=[RefTP.for_region(r, hours=24, seed=1) for r in REGIONS],
        **kw).run()
    got = SweepSpec(
        _pols(policy), paper_family(), demand, TARGETS[:2], sim=cfg,
        placement=PlacementConfig(capacity=20, min_dwell=3),
        regions=[TraceProvider.for_region(r, hours=24, seed=1)
                 for r in REGIONS], device="cpu", **kw).run()
    _assert_rows_match(ref, got)


def test_unplaced_sweep_matches_reference(jax_reference):
    traces = sample_population_matrix(6, days=1, seed=8)
    ref = RefSweepSpec(_pols(ref_policy), ref_paper_family(), traces,
                       TARGETS[:2], carbon=RefTP.for_region("NL", hours=24,
                                                            seed=1),
                       backend="jax").run()
    got = SweepSpec(_pols(policy), paper_family(), traces, TARGETS[:2],
                    carbon=TraceProvider.for_region("NL", hours=24, seed=1),
                    device="cpu").run()
    _assert_rows_match(ref, got)


def test_reference_plan_carried_into_the_port(jax_reference):
    """A plan and slice tables computed by the reference drive the port's
    fleet scan to the reference's own sweep rows."""
    placement_jax, _ = jax_reference
    n = 60
    demand = sample_population_matrix(n, days=1, seed=9)
    ref_eng, _ = engines(n, capacity=int(np.ceil(0.6 * n)))
    ref_rows = RefSweepSpec(_pols(ref_policy), ref_paper_family(), demand,
                            TARGETS, backend="jax", placement=ref_eng).run()
    ref_plan = placement_jax.plan_jax(ref_eng, demand)
    plan, tables = from_reference_arrays(plan=vars(ref_plan),
                                         tables=vars(ref_paper_family()
                                                     .tables()))
    sim = FleetSimulatorTorch(tables)
    results = {}
    for name, mk in _pols(policy).items():
        results[name] = (sim.run(mk(), demand, (plan.region_intensity,
                                                plan.assign),
                                 np.repeat(TARGETS, n), n_rep=len(TARGETS),
                                 device="cpu"), 0)
    rows = _aggregate_sweep_rows(_pols(policy), results, TARGETS, n, plan)
    from repro_torch.core.spec import SweepResult
    _assert_rows_match(ref_rows, SweepResult(rows=rows, backend="torch"))


def test_from_reference_arrays_checks_shapes():
    with pytest.raises(ValueError, match="out of range"):
        from_reference_arrays(plan=dict(
            assign=np.full((3, 2), 5), region_intensity=np.ones((3, 3)),
            migrations=np.zeros(2), overhead_g=np.zeros(2),
            downtime_s=np.zeros(2), region_names=("a", "b", "c"),
            initial=np.zeros(2)))
    with pytest.raises(ValueError, match="shapes"):
        from_reference_arrays(plan=dict(
            assign=np.zeros((3, 2)), region_intensity=np.ones((4, 3))))


def _layer(name):
    from repro_torch.core.elasticity import ElasticityConfig
    from repro_torch.energy import EnergyConfig
    from repro_torch.robustness import FaultPlan
    from repro_torch.traffic import TrafficConfig
    return {"traffic": TrafficConfig, "elasticity": ElasticityConfig,
            "energy": EnergyConfig, "faults": FaultPlan}[name]()


@pytest.mark.parametrize("layer", ["traffic", "elasticity", "energy",
                                   "faults"])
def test_later_layers_raise_not_implemented(layer):
    """The four layers are ported, so none raises NotImplementedError any
    more; a sweep they cannot run is refused as the reference refuses it
    (traffic, elasticity and energy need placement, faults on an
    unplaced sweep a carbon signal to degrade)."""
    spec = SweepSpec(_pols(policy), paper_family(), np.ones((4, 2)),
                     TARGETS[:1], device="cpu", **{layer: _layer(layer)})
    with pytest.raises(ValueError, match="placement|carbon signal"):
        spec.run()


def test_sweep_result_is_a_sequence_of_rows(jax_reference):
    """`SweepResult` iterates and indexes its rows, keeps the spec that
    made it, and reports `violations` as the reference's does."""
    traces = sample_population_matrix(6, days=1, seed=8)
    ref = RefSweepSpec(_pols(ref_policy), ref_paper_family(), traces,
                       TARGETS[:2], carbon=RefTP.for_region("NL", hours=24,
                                                            seed=1),
                       backend="jax").run()
    spec = SweepSpec(_pols(policy), paper_family(), traces, TARGETS[:2],
                     carbon=TraceProvider.for_region("NL", hours=24, seed=1),
                     device="cpu")
    got = spec.run()
    assert got.spec is spec
    assert list(got) == got.rows and len(list(iter(got))) == len(ref)
    assert got[0] is got.rows[0] and got[-1] is got.rows[-1]
    assert [r["policy"] for r in got] == [r["policy"] for r in ref]
    assert got.violations == ref.violations == {}


def test_spec_rejects_other_backends():
    spec = SweepSpec(_pols(policy), paper_family(), np.ones((4, 2)),
                     TARGETS[:1], carbon=TraceProvider.for_region("PL"),
                     backend="jax", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        spec.run()
