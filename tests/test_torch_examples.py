"""The reference's user entry points on the port (`repro_torch.examples`)
and the keyword front door `sweep_population`, against the reference at
the same sizes.

Each example runs with ``--device cpu`` beside the reference's example
(`examples/*.py`, loaded from its file, its flags in ``sys.argv``), and
the printed lines are compared where they are deterministic: every line
of `traffic_demo`, the `simulate_regions` placement and scalar-table
demos, and `carbon_train`'s interval timeline (a virtual clock: the
decisions rest on the analytic step FLOPs, not on a wall clock; slice
names are "dev-n" here, "cpu-n" there). `elasticity_demo` prints the
reference's fleet row where the port prints its torch row. The sweep
rows themselves are held against the reference's at 1e-6 relative with
the counts exact; the reference's JAX sweep runs only under the
`jax_reference` fixture. `quickstart` rests on its own initialisation
(the port cannot draw JAX's random stream) and on wall clocks, so only
its parameter count, checkpoint size and generated shape are compared,
and both its losses fall.
"""
import importlib.util
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_torch_reference import REGIONS, jax_reference  # noqa: E402,F401

from repro.carbon.intensity import TraceProvider as RefTP  # noqa: E402
from repro.cluster.placement import PlacementConfig as RefPC  # noqa: E402
from repro.cluster.placement import PlacementEngine as RefPE  # noqa: E402
from repro.cluster.slices import paper_family as ref_paper_family  # noqa: E402
from repro.core import policy as ref_policy  # noqa: E402
from repro.core.elasticity import ElasticityConfig as RefEC  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.core.simulator import sweep_population as ref_sweep  # noqa: E402
from repro.core.spec import SweepSpec as RefSweepSpec  # noqa: E402
from repro.workload.azure_like import sample_population as ref_sample  # noqa: E402
from repro.workload.azure_like import \
    sample_population_matrix as ref_sample_matrix  # noqa: E402

from repro_torch.carbon.intensity import ConstantProvider  # noqa: E402
from repro_torch.cluster.slices import paper_family  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.core.simulator import SimConfig, sweep_population  # noqa: E402
from repro_torch.core.spec import SweepResult, SweepSpec  # noqa: E402
from repro_torch.examples import (carbon_train, elasticity_demo,  # noqa: E402
                                  quickstart, simulate_regions, traffic_demo)
from repro_torch.workload.azure_like import sample_population  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6
EXACT = ("migrations_mean", "placement_migrations_mean",
         "elastic_level_epochs", "elastic_cap_violations",
         "traffic_replica_epochs")
EXAMPLES = {"quickstart": quickstart, "simulate_regions": simulate_regions,
            "elasticity_demo": elasticity_demo, "traffic_demo": traffic_demo,
            "carbon_train": carbon_train}


def _reference(name, monkeypatch):
    """The reference's example module, loaded from examples/<name>.py
    (importing `carbon_train` sets XLA_FLAGS: undone after the test)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(name, argv, monkeypatch, capsys, patch=None):
    mod = _reference(name, monkeypatch)
    if patch:
        patch(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _run_port(mod, argv, capsys):
    capsys.readouterr()
    out = mod.main([*argv, "--device", "cpu"])
    return out, capsys.readouterr().out


def _rows_match(ref_rows, got_rows):
    ref_rows, got_rows = list(ref_rows), list(got_rows)
    assert len(ref_rows) == len(got_rows)
    for a, b in zip(ref_rows, got_rows):
        assert set(a) == set(b)
        assert (a["policy"], a["target"]) == (b["policy"], b["target"])
        for k, v in a.items():
            if k in EXACT:
                assert b[k] == v, k
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                assert abs(b[k] - v) <= TOL * max(abs(v), 1.0), k
        for k in set(a["time_on_slice"]) | set(b["time_on_slice"]):
            assert abs(a["time_on_slice"].get(k, 0.0)
                       - b["time_on_slice"].get(k, 0.0)) <= TOL


# --- the device policy ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_raise_without_a_card_unless_asked_for_the_cpu(name,
                                                                monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EXAMPLES[name].main([])


# --- the examples -------------------------------------------------------------------

def test_traffic_demo_prints_the_references_lines(monkeypatch, capsys):
    argv = ["--users", "20000"]
    got, text = _run_port(traffic_demo, argv, capsys)
    want = _run_reference("traffic_demo", argv, monkeypatch, capsys)
    assert text == want
    assert got["carbon_saving"] > 0
    # the sweep rows against the reference's fleet rows, same inputs
    pop_args = dict(n_users=20000, n_regions=3, tz_offset_h=(0.0, 8.0, 16.0),
                    seed=3)
    from repro.traffic import (RoutingConfig, TrafficConfig, UserPopulation)
    from repro.traffic.autoscale import ReplicaConfig
    fam = ref_paper_family()
    provs = [RefTP.for_region(r, hours=24, seed=1) for r in REGIONS]
    tc = TrafficConfig(population=UserPopulation(**pop_args),
                       replicas=ReplicaConfig(max_replicas=8, max_step=4,
                                              budget_g_per_epoch=None),
                       routing=RoutingConfig(slo_ms=200.0))
    ref_rows = RefSweepSpec(
        policies={"carbon_containers":
                  lambda: ref_policy.CarbonContainerPolicy("energy")},
        family=fam, traces=[t.util for t in ref_sample(24, days=1, seed=5)],
        targets=[30.0, 60.0], sim=RefSimConfig(target_rate=0.0),
        backend="fleet",
        placement=RefPE(fam, provs, region_names=REGIONS,
                        config=RefPC(capacity=24, min_dwell=6)),
        traffic=tc).run()
    _rows_match(ref_rows, got["sweep_rows"])


def _elastic_ref_rows(n_sweep, backend):
    fam = ref_paper_family()
    return RefSweepSpec(
        policies={"carbon_containers":
                  lambda: ref_policy.CarbonContainerPolicy(variant="energy")},
        family=fam,
        traces=[t.util for t in ref_sample(n_sweep, days=1, seed=5)],
        targets=[40.0], sim=RefSimConfig(target_rate=0.0), backend=backend,
        placement=RefPC(capacity=n_sweep, min_dwell=6),
        regions=[RefTP.for_region(r, hours=24, seed=1) for r in REGIONS],
        region_names=REGIONS,
        elasticity=RefEC(k_levels=4, unit_capacity=0.3,
                         budget_g_per_epoch=150.0, forecast="forecast",
                         shape_budget=True)).run()


def test_elasticity_demo_matches_the_reference(monkeypatch, capsys):
    argv = ["--containers", "150", "--days", "2"]
    got, text = _run_port(elasticity_demo, argv, capsys)
    want = _run_reference("elasticity_demo", argv, monkeypatch, capsys)
    head = lambda s: s.split("\nplaced sweep")[0]  # noqa: E731
    assert head(text) == head(want)
    fleet_row = re.search(r"^ +fleet: (.*)$", want, re.M).group(1)
    assert re.search(r"^ +torch: (.*)$", text, re.M).group(1) == fleet_row
    assert 0 < got["forecast_saving"] <= got["oracle_bound"]
    _rows_match(_elastic_ref_rows(64, "fleet"), got["sweep_rows"])


def test_elasticity_sweep_matches_the_references_jax_rows(jax_reference):
    got = elasticity_demo.main(["--containers", "30", "--days", "1",
                                "--sweep-traces", "8", "--device", "cpu"])
    _rows_match(_elastic_ref_rows(8, "jax"), got["sweep_rows"])


@pytest.mark.parametrize("argv", [["--placement", "--fleet", "9"],
                                  ["--backend", "scalar", "--jobs", "1",
                                   "--fleet", "4"]],
                         ids=["placement", "scalar_tables"])
def test_simulate_regions_prints_the_references_lines(argv, monkeypatch,
                                                      capsys):
    _, text = _run_port(simulate_regions, argv, capsys)
    want = _run_reference("simulate_regions", argv, monkeypatch, capsys)
    assert text == want


def _ref_torch_sweep_rows(n_containers, backend, n_targets=12, days=3):
    n_traces = n_containers // n_targets
    fam = ref_paper_family()
    provs = [RefTP.for_region(r, hours=24 * days, seed=1) for r in REGIONS]
    eng = RefPE(fam, provs, interval_s=300.0, region_names=REGIONS,
                config=RefPC(capacity=int(np.ceil(0.6 * n_traces)),
                             min_dwell=6, hysteresis=0.10))
    return RefSweepSpec(
        policies={"CC (energy)":
                  lambda: ref_policy.CarbonContainerPolicy(variant="energy")},
        family=fam, traces=ref_sample_matrix(n_traces, days=days, seed=3),
        targets=list(np.linspace(20.0, 80.0, n_targets)),
        sim=RefSimConfig(target_rate=0.0), backend=backend,
        placement=eng).run()


def test_simulate_regions_sweep_matches_the_reference(capsys):
    got, text = _run_port(simulate_regions,
                          ["--torch-sweep", "--containers", "240"], capsys)
    sweep = got["torch_sweep"]
    assert sweep["containers"] == 240 and sweep["epochs"] == 864
    assert "torch sweep on cpu: 240 placed containers" in text
    _rows_match(_ref_torch_sweep_rows(240, "fleet"), sweep["rows"])


def test_simulate_regions_sweep_matches_the_references_jax_rows(
        jax_reference):
    got = simulate_regions.torch_sweep(torch.device("cpu"), 48, days=1)
    _rows_match(_ref_torch_sweep_rows(48, "jax", days=1), got["rows"])


def _slice_names(text):
    return text.replace("slice=cpu-", "slice=dev-")


def test_carbon_train_timeline_matches_the_reference(monkeypatch, capsys):
    argv = ["--steps", "24"]
    got, text = _run_port(carbon_train, argv, capsys)

    def eight_chip_slices(mod):          # the reference's 8-device family
        family = mod.demo_family
        monkeypatch.setattr(mod, "demo_family", lambda n: family(8))
    want = _run_reference("carbon_train", argv, monkeypatch, capsys,
                          patch=eight_chip_slices)
    assert _slice_names(want) == text
    assert got["steps"] == 24 and len(got["logs"]) >= 6
    assert got["enforced"] == (got["avg_rate_g_per_h"] <= 45.0)


def test_quickstart_matches_the_references_deterministic_lines(monkeypatch,
                                                              capsys):
    got, text = _run_port(quickstart, ["--steps", "20"], capsys)
    want = _run_reference("quickstart", [], monkeypatch, capsys)
    for pattern in (r"arch=.*params", r"checkpoint: [\d.]+ MB",
                    r"generated \(4, 12\)"):
        assert re.search(pattern, text).group(0) == re.search(
            pattern, want).group(0), pattern
    assert got["loss_last"] < got["loss_first"]
    first, last = map(float, re.search(r"loss: ([\d.]+) -> ([\d.]+)",
                                       want).groups())
    assert last < first
    assert got["tokens"].shape == (4, 12)


# --- sweep_population ------------------------------------------------------------------

def _population(mod_sample, n=6):
    return [t.util for t in mod_sample(n, days=1, seed=4)]


def test_sweep_population_kwargs_return_the_specs_rows():
    traces = _population(sample_population)
    kw = dict(family=paper_family(), traces=traces,
              carbon=ConstantProvider(300.0), targets=[30.0, 60.0])
    pols = {"cc": lambda: policy.CarbonContainerPolicy("energy"),
            "sr": policy.SuspendResumePolicy}
    rows = sweep_population(pols, **kw, cfg_base=SimConfig(target_rate=0.0),
                            device="cpu")
    assert isinstance(rows, list)
    spec = SweepSpec(policies=pols, sim=SimConfig(target_rate=0.0),
                     device="cpu", **kw)
    assert rows == spec.run().rows
    res = sweep_population(spec)
    assert isinstance(res, SweepResult) and res.rows == rows
    with pytest.raises(TypeError):
        sweep_population(spec, family=paper_family())


def test_sweep_population_matches_the_references_fleet_rows():
    from repro.carbon.intensity import ConstantProvider as RefCP
    from test_torch_reference import engines
    traces = _population(sample_population, 8)
    ref_traces = _population(ref_sample, 8)
    pols = lambda m: {"cc": lambda: m.CarbonContainerPolicy("energy"),  # noqa: E731
                      "agnostic": m.CarbonAgnosticPolicy}
    rows = sweep_population(pols(policy), paper_family(), traces,
                            ConstantProvider(250.0), [25.0, 70.0],
                            SimConfig(target_rate=0.0), device="cpu")
    want = ref_sweep(pols(ref_policy), ref_paper_family(), ref_traces,
                     RefCP(250.0), [25.0, 70.0], RefSimConfig(target_rate=0.0),
                     backend="fleet")
    _rows_match(want, rows)
    ref_eng, eng = engines(8, capacity=5)
    rows = sweep_population(pols(policy), paper_family(), traces, None,
                            [25.0, 70.0], SimConfig(target_rate=0.0),
                            placement=eng, device="cpu")
    want = ref_sweep(pols(ref_policy), ref_paper_family(), ref_traces, None,
                     [25.0, 70.0], RefSimConfig(target_rate=0.0),
                     backend="fleet", placement=ref_eng)
    _rows_match(want, rows)


def test_sweep_population_scalar_rows_are_the_references():
    from repro.carbon.intensity import TraceProvider as RefProvider
    from repro_torch.carbon.intensity import TraceProvider
    traces = _population(sample_population, 3)
    pols = lambda m: {"cc": lambda: m.CarbonContainerPolicy("performance"),  # noqa: E731
                      "sr": m.SuspendResumePolicy}
    got = sweep_population(pols(policy), paper_family(), traces,
                           TraceProvider.for_region("NL", hours=24, seed=1),
                           [30.0, 50.0], SimConfig(target_rate=0.0),
                           backend="scalar")
    want = ref_sweep(pols(ref_policy), ref_paper_family(),
                     _population(ref_sample, 3),
                     RefProvider.for_region("NL", hours=24, seed=1),
                     [30.0, 50.0], RefSimConfig(target_rate=0.0),
                     backend="scalar")
    assert got == want


@pytest.mark.parametrize("backend,layer", [("fleet", None), ("jax", None),
                                           ("scalar", "placement"),
                                           ("scalar", "traffic"),
                                           ("scalar", "faults")])
def test_sweep_population_rejects_what_it_cannot_run(backend, layer):
    kw = {layer: object()} if layer else {}
    with pytest.raises(ValueError) as err:
        sweep_population({"a": policy.CarbonAgnosticPolicy}, paper_family(),
                         [np.ones(4)], ConstantProvider(100.0), [45.0],
                         backend=backend, device="cpu", **kw)
    msg = str(err.value)
    assert ("'torch'" in msg and "'scalar'" in msg) if not layer else (
        f"{layer} requires backend='torch'" in msg)
