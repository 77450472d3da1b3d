"""The supply step against the reference: `energy_step` against
`supply_step_np` (bit for bit: the same ops, unfused, on the CPU) and the
reference's `supply_jax` step, and `simulate_supply_torch` against the
host ledger (`simulate_supply`) and `simulate_supply_jax`, with the
ledger's invariants (conservation, no cap or SoC violation)."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_torch_reference import jax_reference  # noqa: E402,F401

from repro.cluster.slices import paper_family as ref_paper_family  # noqa: E402
from repro.energy.supply import (EnergyConfig as RefEC,  # noqa: E402
                                 EnergySpec as RefES, flex_w_per_unit,
                                 simulate_supply, supply_step_np)
from repro_torch.energy.supply import EnergySpec  # noqa: E402
from repro_torch.energy.supply_torch import (energy_step,  # noqa: E402
                                             simulate_supply_torch)

LEDGER = ("solar_used", "charge", "discharge", "grid", "supplied",
          "cap_frac", "c_eff", "soc")


def _spec(n=50, R=3, dt=300.0):
    ref = RefES.from_config(RefEC(), n, R, dt,
                            flex_w_per_unit(ref_paper_family()))
    return ref, EnergySpec(*ref)


def _streams(T=200, R=3, seed=0):
    rng = np.random.default_rng(seed)
    load = rng.uniform(0.0, 4000.0, size=(T, R))
    load[::17] = 0.0                                 # idle epochs
    solar = rng.uniform(0.0, 3000.0, size=(T, R))
    solar[40:90] = 0.0                               # night: the battery drains
    grid_c = rng.uniform(20.0, 600.0, size=(T, R))
    up = (rng.uniform(size=(T, R)) > 0.1).astype(float)
    up[50:70] = 0.0                                  # outage on a drained battery
    return load, solar, grid_c, up


def test_energy_step_equals_numpy_step_bitwise():
    ref_spec, spec = _spec()
    load, solar, grid_c, up = _streams()
    soc_np = np.full(3, ref_spec.soc0_wh)
    soc_t = torch.as_tensor(soc_np)
    drained = 0
    for t in range(load.shape[0]):
        soc_np, outs_np = supply_step_np(ref_spec, soc_np, load[t], solar[t],
                                         grid_c[t], up[t])
        soc_t, outs_t = energy_step(
            spec, soc_t, *(torch.as_tensor(a[t])
                           for a in (load, solar, grid_c, up)))
        assert np.array_equal(soc_t.numpy(), soc_np)
        for a, b in zip(outs_np, outs_t):
            assert np.array_equal(a, b.numpy())
        drained += int((soc_np == 0.0).sum())
    assert drained > 0


def test_simulate_supply_torch_matches_reference(jax_reference):
    from repro.energy.supply_jax import simulate_supply_jax
    ref_spec, spec = _spec()
    streams = _streams()
    want = simulate_supply(*streams, ref_spec)
    want_jax = simulate_supply_jax(*streams, ref_spec)
    got = simulate_supply_torch(*streams, spec, device="cpu")
    for name in LEDGER:
        assert np.array_equal(getattr(want, name), getattr(got, name)), name
        x, y = getattr(want_jax, name), getattr(got, name)
        assert np.max(np.abs(x - y)) <= 1e-9 * max(
            float(np.max(np.abs(x))), 1.0), name
    assert got.summary() == want.summary()
    assert got.conservation_max_err_w <= 1e-6
    assert got.cap_violations == 0 and got.soc_violations == 0
    assert got.summary()["energy_outage_epochs"] > 0


def test_simulate_supply_torch_checks_shapes():
    _, spec = _spec()
    load, solar, grid_c, up = _streams(T=10)
    with pytest.raises(ValueError, match="equal"):
        simulate_supply_torch(load, solar[:5], grid_c, up, spec,
                              device="cpu")
