"""The fault split against the reference: `plan_torch(faults=)` and the
faulted sweep.

The seeded migration-failure mask makes failed attempts pay stop-and-copy
and stay put, with capped exponential backoff; the port's planner must
give the reference's assignments and failed-migration counts exactly.
The faulted sweep decides on the degraded observed feed and bills the
true one: rows within 1e-6 of the reference's `backend="fleet"` and
`backend="jax"` rows, with the same key set and migrations equal.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_reference import engines, jax_reference  # noqa: E402,F401

from repro.carbon.intensity import TraceProvider as RefTP  # noqa: E402
from repro.cluster.slices import paper_family as ref_paper_family  # noqa: E402
from repro.core import policy as ref_policy  # noqa: E402
from repro.core.spec import SweepSpec as RefSweepSpec  # noqa: E402
from repro import robustness as ref_rob  # noqa: E402
from repro_torch import robustness as rob  # noqa: E402
from repro_torch.carbon.intensity import TraceProvider  # noqa: E402
from repro_torch.cluster.placement import plan_torch  # noqa: E402
from repro_torch.cluster.slices import paper_family  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.core.spec import SweepSpec  # noqa: E402

TOL = 1e-6


def _plans(mod, fail_prob=0.25, dropout=0.25, gap=0.1):
    """The same fault plan built from either side's classes."""
    T = 288
    return mod.FaultPlan(
        carbon=mod.CarbonFeedFaults(dropout_prob=dropout,
                                    blackouts=((-1, T // 3, T // 8),)),
        power=mod.PowerTelemetryFaults(gap_prob=gap),
        migration=mod.MigrationFaults(fail_prob=fail_prob, backoff_cap=8),
        degrade=mod.DegradeConfig(mode="ladder", ttl_epochs=3), seed=17)


@pytest.mark.parametrize("capacity", [16, 7])
def test_plan_torch_failed_migrations_equal_reference(jax_reference,
                                                      capacity):
    placement_jax, _ = jax_reference
    n_tr = 16
    ref_eng, eng = engines(n_tr, capacity=capacity, min_dwell=2,
                           hysteresis=0.05)
    demand = np.random.default_rng(3).uniform(0.1, 1.4, size=(288, n_tr))
    ref_flt = ref_rob.FaultPlan(migration=ref_rob.MigrationFaults(
        fail_prob=0.5, backoff_base=1, backoff_cap=8), seed=19)
    flt = rob.FaultPlan(migration=rob.MigrationFaults(
        fail_prob=0.5, backoff_base=1, backoff_cap=8), seed=19)
    want_np = ref_eng.plan(demand, faults=ref_flt)
    want_jax = placement_jax.plan_jax(ref_eng, demand, faults=ref_flt,
                                      admission_impl="xla")
    got = plan_torch(eng, demand, faults=flt, device="cpu")
    for want in (want_np, want_jax):
        assert np.array_equal(got.assign, want.assign)
        assert np.array_equal(got.migrations, want.migrations)
        assert np.array_equal(got.failed_migrations, want.failed_migrations)
        for f in ("overhead_g", "downtime_s"):
            a, b = getattr(want, f), getattr(got, f)
            assert np.all(np.abs(a - b) <= 1e-9 * np.maximum(np.abs(a), 1.0))
    assert got.failed_migrations.sum() > 0
    # the retry gate only ever holds containers back
    plain = plan_torch(eng, demand, device="cpu")
    assert plain.failed_migrations is None
    assert plain.migrations.sum() >= got.migrations.sum()


def test_trivial_plan_counts_no_failures():
    _, eng = engines(1, capacity=None)
    flt = rob.FaultPlan(migration=rob.MigrationFaults(fail_prob=0.5))
    plan = plan_torch(eng, np.ones((0, 4)), faults=flt, device="cpu")
    assert plan.failed_migrations.shape == (4,)
    assert not plan.failed_migrations.any()


def _specs(n_tr=10):
    rng = np.random.default_rng(2)
    traces = rng.uniform(0.1, 1.4, size=(288, n_tr))
    ref_eng, eng = engines(n_tr, capacity=n_tr, min_dwell=2,
                           hysteresis=0.05)
    ref = dict(policies={"cc": lambda: ref_policy.CarbonContainerPolicy(
        variant="energy")}, family=ref_paper_family(), traces=traces,
        targets=(20.0, 45.0), placement=ref_eng, faults=_plans(ref_rob))
    port = dict(policies={"cc": lambda: policy.CarbonContainerPolicy(
        variant="energy")}, family=paper_family(), traces=traces,
        targets=(20.0, 45.0), placement=eng, faults=_plans(rob),
        device="cpu")
    return ref, port


def _assert_rows(ref, got):
    assert len(got) == len(ref)
    assert [set(r) for r in got] == [set(r) for r in ref]
    assert got.parity(ref) <= TOL
    for a, b in zip(ref, got):
        for k in ("migrations_mean", "placement_migrations_mean",
                  "fault_failed_migrations_mean", "fault_max_age"):
            if k in a:
                assert a[k] == b[k], k


def test_fault_sweep_matches_reference(jax_reference):
    ref_kw, kw = _specs()
    got = SweepSpec(**kw).run()
    for backend in ("fleet", "jax"):
        _assert_rows(RefSweepSpec(backend=backend, **ref_kw).run(), got)
    assert got.col("fault_stale_frac").max() > 0.0
    assert got.col("fault_failed_migrations_mean").max() > 0.0
    assert got.col("fault_unmetered_g_mean").max() > 0.0


def test_unplaced_fault_sweep_matches_reference(jax_reference):
    """Without placement the dense (T,) feed is degraded and the
    deciders read it while billing the true one."""
    traces = np.random.default_rng(4).uniform(0.1, 1.4, size=(288, 6))
    ref = RefSweepSpec(
        {"cc": lambda: ref_policy.CarbonContainerPolicy("energy"),
         "sr": ref_policy.SuspendResumePolicy}, ref_paper_family(), traces,
        (30.0, 60.0), carbon=RefTP.for_region("NL", hours=24, seed=1),
        backend="jax", faults=_plans(ref_rob, fail_prob=0.0)).run()
    got = SweepSpec(
        {"cc": lambda: policy.CarbonContainerPolicy("energy"),
         "sr": policy.SuspendResumePolicy}, paper_family(), traces,
        (30.0, 60.0), carbon=TraceProvider.for_region("NL", hours=24, seed=1),
        faults=_plans(rob, fail_prob=0.0), device="cpu").run()
    _assert_rows(ref, got)
    assert got.col("fault_unmetered_g_mean").max() > 0.0
