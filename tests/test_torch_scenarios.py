"""The port's scenario stress matrix against the reference's, at
`tests/test_scenarios.py`'s shape (T = 64, 8 traces, one target): every
cell on the port (CPU) against the reference's `backend="fleet"` rows
(within 1e-6, the same row keys, counts exact, `checks` and `meta`
equal), two cells also against its `backend="jax"` rows, and the
stress masks bit for bit."""
import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_reference import jax_reference  # noqa: E402,F401

from repro.energy import scenarios as ref_sc  # noqa: E402
from repro_torch.energy import scenarios as sc  # noqa: E402

_T, _N = 64, 8
_NAMES = [s.name for s in sc.build_matrix(_T)]
EXACT = ("migrations_mean", "placement_migrations_mean",
         "fault_failed_migrations_mean", "energy_cap_violations",
         "energy_soc_violations", "energy_outage_epochs")


def _cells(name):
    return (next(s for s in sc.build_matrix(_T) if s.name == name),
            next(s for s in ref_sc.build_matrix(_T) if s.name == name))


def _assert_rows(got, want):
    assert len(got.rows) == len(want.rows)
    for a, b in zip(got.rows, want.rows):
        assert set(a) == set(b), sorted(set(a) ^ set(b))
        for k in EXACT:
            if k in b:
                assert a[k] == b[k], k
        assert a["time_on_slice"].keys() == b["time_on_slice"].keys()
    assert got.parity(want) <= sc.PARITY_TOL


def test_matrix_has_the_references_cells():
    assert _NAMES == [s.name for s in ref_sc.build_matrix(_T)]
    for cell, ref in zip(sc.build_matrix(_T), ref_sc.build_matrix(_T)):
        assert cell.description == ref.description
        assert (cell.shape_demand is None) == (ref.shape_demand is None)
        assert (cell.faults is None) == (ref.faults is None)
    assert (sc.CONSERVATION_TOL_W, sc.PARITY_TOL) == (1e-6, 1e-6)


@pytest.mark.parametrize("name", _NAMES)
def test_scenario_equals_the_reference_fleet(name):
    cell, ref_cell = _cells(name)
    got = sc.run_scenario(cell, T=_T, n_tr=_N, targets=(40.0,),
                          devices=("cpu",))
    want = ref_sc.run_scenario(ref_cell, T=_T, n_tr=_N, targets=(40.0,),
                               backends=("fleet",))
    assert got["ok"] and want["ok"]
    assert got["checks"] == want["checks"]
    assert got["meta"] == want["meta"]
    assert got["unmet_frac"] == want["unmet_frac"]
    assert got["outage_epochs"] == want["outage_epochs"]
    assert set(got["sweep_s"]) == {"cpu"}
    _assert_rows(got["results"]["cpu"], want["results"]["fleet"])


@pytest.mark.parametrize("name", ["baseline", "migration_storm"])
def test_scenario_equals_the_reference_jax(name, jax_reference):
    cell, ref_cell = _cells(name)
    got = sc.run_scenario(cell, T=_T, n_tr=_N, targets=(40.0,),
                          devices=("cpu",))
    want = ref_sc.run_scenario(ref_cell, T=_T, n_tr=_N, targets=(40.0,),
                               backends=("jax",))
    assert got["checks"] == want["checks"]
    _assert_rows(got["results"]["cpu"], want["results"]["jax"])


def test_two_devices_report_their_parity():
    cell, _ = _cells("grid_outage")
    out = sc.run_scenario(cell, T=_T, n_tr=_N, targets=(40.0,),
                          devices=("cpu", "cpu"))
    assert out["ok"] and out["checks"]["backend_parity"] == 0.0
    assert out["outage_epochs"] > 0


@pytest.mark.parametrize("T,n", [(64, 8), (288, 24), (96, 7)])
def test_masks_are_bit_identical(T, n):
    assert np.array_equal(sc.churn_mask(T, n), ref_sc.churn_mask(T, n))
    for fn, args in ((sc.failure_mask, (T, n, 300.0)),
                     (sc.straggler_mask, (T, n)),
                     (sc.burst_profile, (T, 300.0))):
        got, meta = fn(*args)
        want, ref_meta = getattr(ref_sc, fn.__name__)(*args)
        assert np.array_equal(got, want) and got.dtype == want.dtype
        assert meta == ref_meta
    for a, b in zip(sc._shared_inputs(T, n), ref_sc._shared_inputs(T, n)):
        assert np.array_equal(a, b)


def test_cli_runs_the_matrix_on_the_cpu(capsys):
    assert sc.main(["--fast", "--devices", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "all 10 scenarios hold" in out
    for name in _NAMES:
        assert name in out
