"""The JAX reference, made callable for the port's parity tests.

jax 0.9 has no `jax.experimental.enable_x64`, so the reference's JAX
sweep modules (the placement and fleet scans, the traffic and energy
steps, the elasticity scan) import with ``HAS_JAX = False``. The
`jax_reference` fixture patches their five module globals (``HAS_JAX``,
``jax``, ``jnp``, ``lax``, ``enable_x64 = jax.enable_x64``) for one test
and undoes them after it, so the reference's own tests see the modules
exactly as imported. Other `test_torch_*` files import the fixture and
the shared input helpers from here.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import repro.cluster.placement_jax as ref_placement_jax  # noqa: E402
import repro.core.elasticity_jax as ref_elasticity_jax  # noqa: E402
import repro.core.fleet_jax as ref_fleet_jax  # noqa: E402
import repro.energy.supply_jax as ref_supply_jax  # noqa: E402
import repro.traffic.sim_jax as ref_sim_jax  # noqa: E402

REGIONS = ("PL", "NL", "CAISO")
REF_MODULES = (ref_placement_jax, ref_fleet_jax, ref_elasticity_jax,
               ref_sim_jax, ref_supply_jax)


def patch_reference(monkeypatch):
    for mod in REF_MODULES:
        monkeypatch.setattr(mod, "HAS_JAX", True)
        monkeypatch.setattr(mod, "jax", jax)
        monkeypatch.setattr(mod, "jnp", jnp)
        monkeypatch.setattr(mod, "lax", lax)
        monkeypatch.setattr(mod, "enable_x64", jax.enable_x64)


@pytest.fixture
def jax_reference(monkeypatch):
    """The reference's JAX sweep modules, runnable for the duration of
    one test; returns the placement and fleet-scan modules."""
    patch_reference(monkeypatch)
    return ref_placement_jax, ref_fleet_jax


def engines(n, capacity, days=1, min_dwell=6, hysteresis=0.10):
    """The same PL/NL/CAISO placement engine on both sides."""
    from repro.carbon.intensity import TraceProvider as RefTP
    from repro.cluster.placement import (PlacementConfig as RefPC,
                                         PlacementEngine as RefPE)
    from repro.cluster.slices import paper_family as ref_paper_family

    from repro_torch.carbon.intensity import TraceProvider
    from repro_torch.cluster.placement import PlacementConfig, PlacementEngine
    from repro_torch.cluster.slices import paper_family
    ref = RefPE(ref_paper_family(),
                [RefTP.for_region(r, hours=24 * days, seed=1) for r in REGIONS],
                region_names=REGIONS,
                config=RefPC(capacity=capacity, min_dwell=min_dwell,
                             hysteresis=hysteresis))
    port = PlacementEngine(
        paper_family(),
        [TraceProvider.for_region(r, hours=24 * days, seed=1) for r in REGIONS],
        region_names=REGIONS,
        config=PlacementConfig(capacity=capacity, min_dwell=min_dwell,
                               hysteresis=hysteresis))
    return ref, port


def test_reference_runs_under_the_fixture(jax_reference):
    placement_jax, fleet_jax = jax_reference
    assert all(m.HAS_JAX for m in REF_MODULES)
    from repro.workload.azure_like import sample_population_matrix
    demand = sample_population_matrix(12, days=1, seed=3)
    ref, _ = engines(12, capacity=6)
    plan = placement_jax.plan_jax(ref, demand, admission_impl="xla")
    assert np.array_equal(plan.assign, ref.plan(demand).assign)


def test_patch_is_undone_after_the_test(monkeypatch):
    before = [(m.HAS_JAX, m.enable_x64) for m in REF_MODULES]
    patch_reference(monkeypatch)
    assert all(m.HAS_JAX for m in REF_MODULES)
    monkeypatch.undo()
    assert [(m.HAS_JAX, m.enable_x64) for m in REF_MODULES] == before
