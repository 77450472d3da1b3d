"""The manifest's rules, each cell's files found by name, the harness's
refusals, and a whole run of each cell at the small size on the CPU:
sound, and with each fault the cell can have planted in the program,
where ``correct`` has to come out false. (A cell on several cards, and
its faults, in `test_portbench_ranks.py`.)"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys

import pytest
import torch

import portbench_cases
from portbench import harness

ROOT = portbench_cases.ROOT
MAN = portbench_cases.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TRAIN = [c for c in CELLS if ".train-" in c]
SERVE = [c for c in CELLS if ".serve-" in c]


def test_manifest_names_units_and_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    names = [x["name"] for x in MAN["configs"] + MAN["workloads"] + metrics]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in metrics}) == len(metrics)
    assert all(UNIT.match(x["unit"]) for x in metrics)
    assert all(x["better"] in ("lower", "higher") for x in metrics)
    assert {m["name"] for m in MAN["end_to_end"]} >= {"setup_s"}
    assert all(m["workloads"] for m in MAN["per_layer"])
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    chips = [w["chips"] for w in MAN["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(len(chips) // 4, 1)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = harness.cell(MAN, cell)
    conf = harness.load_json(ROOT / "portbench" / "configs"
                             / f"{w['config']}.json")
    assert any(c["file"] == f"portbench/configs/{w['config']}.json"
               and c["reduced"] == conf["reduced"] for c in MAN["configs"])
    work = harness.load_json(ROOT / "portbench" / "workloads"
                             / f"{cell}.json")
    kind = harness.load_module(ROOT / "portbench" / "traffic"
                               / f"{work['traffic']['kind']}.py")
    assert callable(kind.setup)
    assert harness.model_config(conf).dtype == conf["precision"]["activations"]
    e2e = {m["name"] for m in harness.end_to_end(MAN, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = harness.per_layer(MAN, cell)
    assert layers
    for spec in layers:
        assert spec["moves"] in e2e
        mod = harness.load_module(ROOT / "portbench" / "metrics"
                                  / f"{spec['name']}.py")
        assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
            spec["name"], spec["unit"], spec["layer"], spec["moves"])


def test_one_name_a_layer():
    layers = {}
    for m in MAN["per_layer"]:
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints no result; so it
    does in a directory that holds only the manifest and portbench/."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", CELLS[0],
             "--seed", str(portbench_cases.SEED), "--seconds", "1"],
            cwd=where, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0
        assert p.stdout.strip() == ""


def test_bytecode_cached_inside_the_checkout(tmp_path):
    """A run keeps the bytecode of the modules it imports (torch's among
    them) in the checkout's build/pycache, a fixed path, so that only a
    checkout's first run compiles them."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go on to set up")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    cached = tmp_path / "build" / "pycache"
    assert any(cached.rglob("torch/__init__*.pyc"))
    assert any(cached.rglob("harness*.pyc"))


@pytest.mark.parametrize("cell", CELLS)
def test_small_run_is_correct(cell):
    res = portbench_cases.run_small(cell)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in harness.end_to_end(MAN, cell)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "compared"


def test_small_traced_run_reads_its_host_metrics():
    res = portbench_cases.run_small(TRAIN[0], trace=True)
    assert res["correct"]
    assert res["metrics"]["mfu.train"]["value"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", SERVE)
def test_small_traced_serve_reads_the_untraced_window(cell):
    """The engine's counters and the host's times come from the measured
    window, which runs whole before the traced stretch; the device's
    metrics from the trace."""
    res = portbench_cases.run_small(cell, trace=True, seconds=0.1)
    assert res["correct"]
    want = {m["name"] for m in harness.per_layer(MAN, cell)}
    got = set(res["metrics"])
    assert {"mfu.serve", "decode_step_ms.serve"} <= got <= want
    small = portbench_cases.small(cell)["work"]["traffic"]
    assert res["attempted"] > small["trace_batches"] * small["batch"]


@pytest.mark.parametrize("fault", [portbench_cases.unchanged_state,
                                   portbench_cases.half_batch],
                         ids=["unchanged_state", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_training_fault_is_not_correct(cell, fault):
    assert not portbench_cases.run_small(cell, faults=[fault])["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_altered_token_is_not_correct(cell, monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    generate = ServeEngine.generate

    def altered(self, prompts, max_new_tokens, **kw):
        out = generate(self, prompts, max_new_tokens, **kw)
        out["tokens"][-1, 0] = (out["tokens"][-1, 0] + 1) % \
            self.model.cfg.vocab_size
        return out
    monkeypatch.setattr(ServeEngine, "generate", altered)
    assert not portbench_cases.run_small(
        cell, traffic={"check_requests": 100})["correct"]
