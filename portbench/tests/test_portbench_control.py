"""Each cell's control: the plain reference put in the program's place
and computed in emulated fp8, the step below the configurations' bf16.

On the card, at the cell's own size (the ``cuda`` marker; skipped
without a card), the control and the planted faults fail the cell's
limits as `portbench/control.py` reads them. On the CPU, at the small
size, the control reads well above the program in bf16 on the same
inputs, on one of the cell's numbers."""
from __future__ import annotations

import pytest
import torch

import portbench_cases
from portbench import harness
from portbench.reference import common as C
from portbench.reference import drive

ROOT = portbench_cases.ROOT
MAN = portbench_cases.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
TRAIN = [c for c in CELLS if ".train-" in c]
SERVE = [c for c in CELLS if ".serve-" in c]
control = harness.load_module(ROOT / "portbench" / "control.py")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    return torch.device("cuda")


def _run(cell, device, seed=portbench_cases.SEED, **small):
    w = harness.cell(MAN, cell)
    conf = small.get("conf") or harness.load_json(
        harness.BENCH / "configs" / f"{w['config']}.json")
    work = small.get("work") or harness.load_json(
        harness.BENCH / "workloads" / f"{cell}.json")
    return harness.Run(cell, seed, torch.device(device), conf, work,
                       small.get("model_cfg") or harness.model_config(conf))


def _kind(run):
    return harness.load_module(ROOT / "portbench" / "traffic"
                               / f"{run.traffic['kind']}.py")


def _fails(readings: dict, limits: dict) -> bool:
    return any(v > limits[n] for n, v in readings.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN)
def test_training_control_and_half_batch_fail_on_the_card(cell, card):
    run = _run(cell, card)
    got = control.train_readings(run, _kind(run).compare)
    assert _fails(got["control_fp8"], run.work["limits"])
    assert _fails(got["half_batch"], run.work["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", SERVE)
def test_serving_control_and_altered_token_fail_on_the_card(cell, card):
    run = _run(cell, card)
    got = control.serve_readings(run, _kind(run).setup(run), 10.0)
    limits = run.work["limits"]
    assert not _fails(got["program"], limits)
    assert _fails(got["control_fp8"], limits)
    assert _fails(got["token_altered"], limits)


@pytest.mark.parametrize("cell", TRAIN)
def test_training_control_reads_above_the_program(cell):
    small = portbench_cases.small(cell)
    run = _run(cell, "cpu", **small)
    got = control.train_readings(run, _kind(run).compare)
    program = portbench_cases.run_small(cell, dtype="bfloat16")["compared"]
    assert any(got["control_fp8"][n] > 3 * program[n]["value"]
               for n in program), (got, program)


@pytest.mark.parametrize("cell", SERVE)
def test_serving_control_reads_above_the_program(cell):
    kw = portbench_cases.small(cell)
    m, family = kw["conf"]["model"], kw["conf"]["family"]
    params = C.init_params(drive.family(family).layout(m),
                           portbench_cases.SEED, "cpu")
    rows = C.token_rows(portbench_cases.SEED, 0, 8, 33, m["vocab_size"],
                        "cpu")
    ref = drive.served_logits(family, m, params, rows, 2)
    ctl = drive.served_logits(family, m, params, rows, 2, precision="fp8")
    program = portbench_cases.run_small(cell, dtype="bfloat16")["compared"]
    assert drive.widest_gap(ref, ctl.argmax(-1)) > \
        3 * program["logit_gap"]["value"]
