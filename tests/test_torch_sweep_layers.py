"""The placed sweep with its layers against the reference, and the placed
fleet run (`PlacementEngine.run`).

Each layer alone (traffic, energy, elasticity, faults), traffic and
energy folded into the scan under a fault plan, and all four layers with
the fault plan: the port's rows must have the reference's key set and
lie within 1e-6 of both its `backend="fleet"` and `backend="jax"` rows,
with migrations, failed migrations, elastic level-epochs and the
violation counts exact. Sizes: 12 traces, one day of 5-minute epochs,
5,000 users.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_reference import jax_reference  # noqa: E402,F401

import repro.cluster.placement as ref_placement  # noqa: E402
import repro.core.elasticity as ref_elasticity  # noqa: E402
import repro.energy as ref_energy  # noqa: E402
import repro.robustness as ref_robustness  # noqa: E402
import repro.traffic as ref_traffic  # noqa: E402
import repro_torch.cluster.placement as placement  # noqa: E402
import repro_torch.core.elasticity as elasticity  # noqa: E402
import repro_torch.energy as energy  # noqa: E402
import repro_torch.robustness as robustness  # noqa: E402
import repro_torch.traffic as traffic  # noqa: E402
from repro.cluster.slices import paper_family as ref_paper_family  # noqa: E402
from repro.core import policy as ref_policy  # noqa: E402
from repro.core.spec import SweepSpec as RefSweepSpec  # noqa: E402
from repro_torch.cluster.slices import paper_family  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.core.spec import SweepSpec  # noqa: E402

TOL = 1e-6
T, N_TR = 288, 12
TARGETS = (20.0, 60.0)
EXACT = ("migrations_mean", "placement_migrations_mean",
         "fault_failed_migrations_mean", "elastic_level_epochs",
         "elastic_cap_violations", "energy_cap_violations",
         "energy_soc_violations", "energy_outage_epochs",
         "traffic_replica_epochs")
PREFIX = {"traffic": "traffic_", "energy": "energy_",
          "elasticity": "elastic_", "faults": "fault_"}


def _regions():
    t = np.linspace(0, 4 * np.pi, T)
    return np.stack([200 + 150 * np.sin(t + p) for p in (0.0, 1.5, 3.0)],
                    axis=1) + 50.0


def _side(pl, el, en, rob, tr, pol, fam):
    """The sweep's pieces from one side's modules."""
    return dict(
        policies={"cc": lambda: pol.CarbonContainerPolicy("energy"),
                  "agnostic": pol.CarbonAgnosticPolicy},
        family=fam(),
        placement=pl.PlacementEngine(
            fam(), _regions(), config=pl.PlacementConfig(capacity=8,
                                                         min_dwell=2)),
        traffic=tr.TrafficConfig(population=tr.UserPopulation(
            n_users=5000, n_regions=3, seed=3)),
        elasticity=el.ElasticityConfig(
            k_levels=4, unit_capacity=0.3, budget_g_per_epoch=2.5 * N_TR,
            forecast="forecast", shape_budget=True),
        energy=en.EnergyConfig(events=en.GridEventConfig(
            outages=((1, T // 3, T // 24),),
            shocks=((-1, T // 2, T // 12, 1.6),))),
        faults=rob.FaultPlan(
            carbon=rob.CarbonFeedFaults(dropout_prob=0.2,
                                        blackouts=((-1, T // 3, T // 12),)),
            power=rob.PowerTelemetryFaults(gap_prob=0.05),
            migration=rob.MigrationFaults(fail_prob=0.3, backoff_cap=8),
            degrade=rob.DegradeConfig(mode="ladder", ttl_epochs=3),
            seed=11))


def _sides():
    ref = _side(ref_placement, ref_elasticity, ref_energy, ref_robustness,
                ref_traffic, ref_policy, ref_paper_family)
    port = _side(placement, elasticity, energy, robustness, traffic, policy,
                 paper_family)
    return ref, port


def _run(spec_cls, side, layers, **kw):
    args = {k: side[k] for k in ("policies", "family", "placement") + layers}
    traces = np.random.default_rng(1).uniform(0.2, 1.6, size=(T, N_TR))
    return spec_cls(traces=traces, targets=TARGETS, **args, **kw).run()


@pytest.mark.parametrize("layers", [
    ("traffic",), ("energy",), ("elasticity",), ("faults",),
    ("traffic", "energy", "faults"),
    ("traffic", "energy", "elasticity", "faults")],
    ids=lambda layers: "+".join(layers))
def test_layered_sweep_matches_reference(jax_reference, layers):
    ref, port = _sides()
    got = _run(SweepSpec, port, layers, device="cpu")
    assert len(got) == len(TARGETS) * 2
    for backend in ("fleet", "jax"):
        want = _run(RefSweepSpec, ref, layers, backend=backend)
        assert [set(r) for r in got] == [set(r) for r in want]
        assert got.parity(want) <= TOL, backend
        assert got.violations == want.violations
        for a, b in zip(want, got):
            for k in EXACT:
                if k in a:
                    assert a[k] == b[k], (backend, k)
    for layer in layers:
        assert any(k.startswith(PREFIX[layer]) for k in got[0]), layer
    assert all(v == 0.0 for v in got.violations.values())


@pytest.mark.parametrize("compare_static", [False, True])
def test_placement_engine_run_matches_reference(compare_static):
    ref, port = _sides()
    demand = np.random.default_rng(6).uniform(0.1, 1.4, size=(T, N_TR))
    targets = np.linspace(20.0, 80.0, N_TR)
    kw = dict(epsilon=0.1, state_gb=2.0, demand_scale=1.2,
              compare_static=compare_static)
    want = ref["placement"].run(ref_policy.CarbonContainerPolicy("energy"),
                                demand, targets, **kw)
    got = port["placement"].run(policy.CarbonContainerPolicy("energy"),
                                demand, targets, device="cpu", **kw)
    assert np.array_equal(got.plan.assign, want.plan.assign)
    assert np.array_equal(got.plan.migrations, want.plan.migrations)
    assert np.array_equal(got.plan.carbon_matrix(), want.plan.carbon_matrix())
    assert np.array_equal(got.fleet.migrations, want.fleet.migrations)
    for f in ("total_emissions_g", "carbon_efficiency"):
        a, b = getattr(want, f), getattr(got, f)
        assert np.all(np.abs(a - b) <= TOL * np.maximum(np.abs(a), 1.0)), f
    if compare_static:
        a, b = want.saving_vs_static_pct, got.saving_vs_static_pct
        assert abs(a - b) <= TOL * max(abs(a), 1.0)
        assert np.array_equal(got.static_fleet.migrations,
                              want.static_fleet.migrations)
        assert want.plan.migrations.sum() > 0
    else:
        with pytest.raises(ValueError, match="compare_static"):
            got.saving_vs_static_pct
    # a precomputed plan is reused as it is
    again = port["placement"].run(policy.CarbonContainerPolicy("energy"),
                                  demand, targets, plan=got.plan,
                                  device="cpu", **kw)
    assert np.array_equal(again.fleet.emissions_g, got.fleet.emissions_g)
    with pytest.raises(ValueError, match="plan covers"):
        port["placement"].run(policy.CarbonAgnosticPolicy(), demand[:10],
                              targets, plan=got.plan, device="cpu")
