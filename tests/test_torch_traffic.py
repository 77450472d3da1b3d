"""The traffic step against the reference: `simulate_traffic_torch` and
`traffic_step` against the host pipeline (`simulate_traffic`) and the
reference's `sim_jax`, within 1e-6 with replica counts exact, for both
routing policies, with and without a carbon budget."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_torch_reference import jax_reference  # noqa: E402,F401

from repro.traffic import (TrafficConfig as RefTC,  # noqa: E402
                           UserPopulation as RefUP, request_matrix)
from repro.traffic.autoscale import ReplicaConfig as RefRC  # noqa: E402
from repro.traffic.routing import RoutingConfig as RefRT  # noqa: E402
from repro.traffic.sim import simulate_traffic  # noqa: E402
from repro_torch.traffic import (TrafficConfig, UserPopulation,  # noqa: E402
                                 simulate_traffic as port_simulate_traffic)
from repro_torch.traffic.autoscale import ReplicaConfig  # noqa: E402
from repro_torch.traffic.routing import RoutingConfig  # noqa: E402
from repro_torch.traffic.sim_torch import (TrafficSpec,  # noqa: E402
                                           simulate_traffic_torch,
                                           traffic_step)

TOL = 1e-6
FIELDS = ("routed", "served", "dropped_route", "dropped_cap", "violations",
          "emissions_g")


def _configs(policy, budget, spill=True):
    # 0.1 requests/s a replica: a region's ~300 requests an epoch need
    # ~10 replicas, so the ramp, the ceiling and the budget all bind
    kw = dict(throughput_rps=0.1, max_replicas=8, max_step=2,
              budget_g_per_epoch=budget)
    ref = RefTC(population=RefUP(n_users=5000, n_regions=3, seed=0),
                routing=RefRT(policy=policy, spill=spill),
                replicas=RefRC(**kw))
    port = TrafficConfig(population=UserPopulation(n_users=5000, n_regions=3,
                                                   seed=0),
                         routing=RoutingConfig(policy=policy, spill=spill),
                         replicas=ReplicaConfig(**kw))
    return ref, port


def _inputs(ref_cfg, T=96):
    arr = request_matrix(ref_cfg.population, T, 300.0)
    rng = np.random.default_rng(11)
    carbon = 100.0 + 500.0 * rng.random((T, 3))
    carbon[7] = 0.0                      # zero-gram epoch: free replicas
    return arr.requests, carbon


def _assert_close(want, got):
    np.testing.assert_array_equal(got.replicas, want.replicas)
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert np.max(np.abs(a - b)) <= TOL * max(
            float(np.max(np.abs(a))), 1.0), f


@pytest.mark.parametrize("policy,budget,spill", [
    ("carbon", None, True), ("carbon", 25.0, True), ("latency", 25.0, True),
    ("latency", None, False)])
def test_simulate_traffic_torch_matches_reference(jax_reference, policy,
                                                  budget, spill):
    from repro.traffic.sim_jax import simulate_traffic_jax
    ref_cfg, cfg = _configs(policy, budget, spill)
    req, carbon = _inputs(ref_cfg)
    want_np = simulate_traffic(req, carbon, ref_cfg)
    want_jax = simulate_traffic_jax(req, carbon, ref_cfg)
    got = simulate_traffic_torch(req, carbon, cfg, device="cpu")
    _assert_close(want_np, got)
    _assert_close(want_jax, got)
    # the budget binds: some epochs run fewer replicas than they need
    if budget is not None:
        uncapped = simulate_traffic_torch(req, carbon,
                                          _configs(policy, None, spill)[1],
                                          device="cpu")
        assert (got.replicas < uncapped.replicas).any()
    # the host copy of the pipeline gives the reference's ledger bit for bit
    host = port_simulate_traffic(req, carbon, cfg)
    for f in FIELDS + ("replicas",):
        assert np.array_equal(getattr(host, f), getattr(want_np, f)), f


def test_traffic_step_matches_reference_step(jax_reference):
    """One epoch from a mid-run replica carry, output by output."""
    import jax
    import jax.numpy as jnp

    from repro.traffic.sim_jax import TrafficSpec as RefSpec
    from repro.traffic.sim_jax import traffic_step as ref_step
    ref_cfg, cfg = _configs("carbon", 25.0)
    req, carbon = _inputs(ref_cfg)
    rep0 = np.array([3.0, 5.0, 1.0])
    spec = TrafficSpec.from_config(cfg, 300.0)
    assert tuple(spec) == tuple(RefSpec.from_config(ref_cfg, 300.0))
    with jax.enable_x64():
        for t in (0, 7, 40):
            w_rep, w_outs = ref_step(RefSpec.from_config(ref_cfg, 300.0),
                                     jnp.asarray(rep0), jnp.asarray(req[t]),
                                     jnp.asarray(carbon[t]))
            g_rep, g_outs = traffic_step(spec, torch.as_tensor(rep0),
                                         torch.as_tensor(req[t]),
                                         torch.as_tensor(carbon[t]))
            assert np.array_equal(np.asarray(w_rep), g_rep.numpy())
            for a, b in zip(w_outs, g_outs):
                a = np.asarray(a)
                assert np.max(np.abs(a - b.numpy())) <= TOL * max(
                    float(np.max(np.abs(a))), 1.0)


def test_simulate_traffic_torch_checks_shapes():
    _, cfg = _configs("carbon", None)
    with pytest.raises(ValueError, match="must be"):
        simulate_traffic_torch(np.ones((4, 2)), np.ones((4, 2)), cfg,
                               device="cpu")
