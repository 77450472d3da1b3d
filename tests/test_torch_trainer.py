"""The carbon-aware trainer against the JAX reference, on the CPU: step
telemetry, the elastic job's checkpoint / migrate / suspend / resume
round trips, `CarbonAwareTrainer`'s interval logs on the reference
test's scenario and on one with a duty below 1, a migration and a
suspend/resume, and the training launcher with and without a carbon
target. The trainer's decisions run on a virtual clock, so its logs
depend on the telemetry and the carbon trace, not on the model."""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.carbon.intensity import TraceProvider as RefTraceProvider  # noqa: E402
from repro.cluster.slices import Slice as RefSlice  # noqa: E402
from repro.cluster.slices import SliceFamily as RefSliceFamily  # noqa: E402
from repro.config import CarbonConfig as RefCarbonConfig  # noqa: E402
from repro.config import OptimizerConfig as RefOptCfg  # noqa: E402
from repro.config import TrainConfig as RefTrainCfg  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.carbon_aware_trainer import \
    CarbonAwareTrainer as RefTrainer  # noqa: E402
from repro.core.elastic import ElasticJob as RefJob  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.power import telemetry as REF_TEL  # noqa: E402
from repro.power.model import LinearPowerModel as RefLPM  # noqa: E402

from repro_torch.carbon.intensity import TraceProvider  # noqa: E402
from repro_torch.cluster.slices import Slice, SliceFamily  # noqa: E402
from repro_torch.config import (CarbonConfig, OptimizerConfig,  # noqa: E402
                                TrainConfig)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.carbon_aware_trainer import (  # noqa: E402
    H100_BF16_PEAK_FLOPS, CarbonAwareTrainer)
from repro_torch.core.elastic import ElasticJob  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.power import telemetry as TEL  # noqa: E402
from repro_torch.power.model import LinearPowerModel  # noqa: E402

# (hourly carbon trace, target g/h, simulated seconds a step, steps): the
# reference test's scenario (`tests/test_moe_and_trainer.py:57`), and one
# that also cuts the duty below 1 (800 g/kWh), suspends (2,000) and
# resumes (100), whose first 6 steps `chip_smoke.py` runs at full width
SCENARIOS = {"reference": ([400.0] * 48, 40.0, 150.0, 30),
             "duty_suspend": ([400.0, 800.0, 2000.0, 100.0] * 12, 40.0,
                              600.0, 16)}


def _tel_records(seed, n=40):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(5.0, 120.0, n))
    return [dict(t=float(t[i]), step_time_s=float(rng.uniform(1.0, 60.0)),
                 tokens=int(rng.integers(1, 10_000)),
                 flops=float(rng.uniform(1e12, 1e15)),
                 duty=float(rng.uniform(0.1, 1.0))) for i in range(n)]


def test_telemetry_equals_the_reference():
    """`mfu_utilization` and a rolling `TelemetryWindow` (utilization and
    token rate after every record) bit-equal to the reference's."""
    for args in ((1e15, 2.0, 4, 197e12), (1e12, 0.0, 1, 1e12),
                 (5e14, 3.0, 1, 989e12)):
        assert TEL.mfu_utilization(*args) == REF_TEL.mfu_utilization(*args)
    ours, ref = TEL.TelemetryWindow(300.0), REF_TEL.TelemetryWindow(300.0)
    assert ours.utilization(1, 1e12) == ref.utilization(1, 1e12) == 0.0
    for rec in _tel_records(0):
        ours.record(TEL.StepTelemetry(**rec))
        ref.record(REF_TEL.StepTelemetry(**rec))
        assert len(ours.steps) == len(ref.steps)
        assert ours.utilization(2, 1e13) == ref.utilization(2, 1e13)
        assert ours.throughput_tokens_s() == ref.throughput_tokens_s()


def _smoke_job(tmp, **tkw):
    cfg = get_arch("smollm-135m").smoke
    tcfg = TrainConfig(seq_len=16, global_batch=4, **tkw)
    return ElasticJob(get_model(cfg), tcfg, tmp), cfg


def _host(state):
    return {p: t.clone() for p, t in flatten(state)}


def _same(a, b):
    return set(a) == set(b) and all(
        a[p].dtype == b[p].dtype and torch.equal(a[p], b[p]) for p in a)


def test_elastic_job_round_trips(tmp_path):
    """migrate, suspend / resume and recover_after_failure restore the
    saved state bit for bit; the step counter follows; a job with the
    same seed and batches but no interruption takes the same steps and
    losses, bit for bit."""
    job, cfg = _smoke_job(str(tmp_path / "a"))
    twin, _ = _smoke_job(str(tmp_path / "b"))
    job.start(["cpu"])
    twin.start(["cpu"])
    data = iter(SyntheticLM(cfg.vocab_size, 16, 4, seed=1))
    batches = [next(data) for _ in range(6)]
    losses = [job.train_step(batches[0])["loss"]]
    before = _host(job.state)
    rec = job.migrate(["cpu"])
    assert rec["bytes"] == sum(t.nbytes for t in before.values())
    assert rec["step"] == 1 and rec["n_devices"] == 1 and rec["save_s"] >= 0
    assert _same(_host(job.state), before) and job.migrations == [rec]
    losses.append(job.train_step(batches[1])["loss"])
    before = _host(job.state)
    info = job.suspend()
    assert job.state is None and info["bytes"] > 0
    assert job.resume(["cpu"]) == {"resumed_at_step": 2, "n_devices": 1}
    assert _same(_host(job.state), before)
    losses.append(job.train_step(batches[2])["loss"])
    job.checkpoint()
    losses.append(job.train_step(batches[3])["loss"])
    assert job.recover_after_failure(["cpu"])["resumed_at_step"] == 3
    assert job.step_idx == 3
    losses[-1:] = [job.train_step(batches[3])["loss"]]
    twin_losses = [twin.train_step(b)["loss"] for b in batches[:4]]
    assert losses == twin_losses
    assert _same(_host(job.state), _host(twin.state))
    with pytest.raises(ValueError, match="one device"):
        job.migrate([])


def _run_pair(scenario):
    """The same scenario through the reference's trainer and the port's
    (smollm smoke, CPU). Returns both `run` outputs."""
    trace, target, sim_s, steps = SCENARIOS[scenario]
    outs = []
    for side in ("ref", "port"):
        ref = side == "ref"
        cfg = (ref_get_arch if ref else get_arch)("smollm-135m").smoke
        model = (ref_get_model if ref else get_model)(cfg)
        opt = (RefOptCfg if ref else OptimizerConfig)(warmup_steps=1,
                                                      total_steps=100)
        tcfg = (RefTrainCfg if ref else TrainConfig)(seq_len=16,
                                                     global_batch=4,
                                                     optimizer=opt)
        lpm, sl, fam = ((RefLPM, RefSlice, RefSliceFamily) if ref else
                        (LinearPowerModel, Slice, SliceFamily))
        slices = [sl("s1", 0.5, lpm(30.0, 80.0), chips=1),
                  sl("s2", 1.0, lpm(60.0, 160.0), chips=1)]
        devs = jax.devices()[:1] if ref else ["cpu"]
        with tempfile.TemporaryDirectory() as d:
            job = (RefJob if ref else ElasticJob)(model, tcfg, d)
            job.start(devs)
            step_flops = 6.0 * model.param_count() * 16 * 4
            trainer = (RefTrainer if ref else CarbonAwareTrainer)(
                job=job, family=fam(slices, baseline_idx=1),
                slice_devices=[devs, devs],
                carbon=(RefTraceProvider if ref else TraceProvider)(trace),
                cfg=(RefCarbonConfig if ref else CarbonConfig)(
                    target_rate=target, interval_s=300.0),
                step_flops=step_flops, step_tokens=64,
                peak_flops_per_chip=step_flops / 120.0,
                sim_seconds_per_step=sim_s)
            data = (RefSyntheticLM if ref else SyntheticLM)(cfg.vocab_size,
                                                            16, 4)
            outs.append(trainer.run(iter(data), steps))
    return outs


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_trainer_interval_logs_equal_the_reference(scenario):
    """Every interval log (time, intensity, utilization, power, carbon
    rate, slice, duty, suspended, action) exactly equal to the
    reference's, the same migrations at the same steps, and the average
    carbon rate within the reference test's bar (1.1 x target)."""
    ref, ours = _run_pair(scenario)
    assert ours["steps"] == ref["steps"] == SCENARIOS[scenario][3]
    assert [dataclasses.asdict(x) for x in ours["logs"]] == [
        dataclasses.asdict(x) for x in ref["logs"]]
    assert [m["step"] for m in ours["migrations"]] == [
        m["step"] for m in ref["migrations"]]
    rates = [x.carbon_rate for x in ours["logs"]]
    assert sum(rates) / len(rates) <= SCENARIOS[scenario][1] * 1.1
    kinds = {x.action for x in ours["logs"]}
    assert "migrate" in kinds
    if scenario == "duty_suspend":
        assert {"suspend", "resume"} <= kinds
        assert any(x.duty < 1.0 and not x.suspended for x in ours["logs"])


def test_trainer_peak_is_the_cards():
    assert CarbonAwareTrainer.__dataclass_fields__[
        "peak_flops_per_chip"].default == H100_BF16_PEAK_FLOPS == 989e12


@pytest.mark.parametrize("carbon", [False, True])
def test_train_launcher_runs_on_the_cpu(carbon, capsys):
    """`python -m repro_torch.launch.train --device cpu` on the smoke
    config, with and without a carbon target; ``--device`` defaults to
    the card and raises without one."""
    argv = ["--arch", "smollm-135m", "--steps", "4", "--global-batch", "2",
            "--seq-len", "16", "--log-every", "0", "--device", "cpu"]
    if carbon:
        argv += ["--carbon-target", "3000", "--region", "NL",
                 "--sim-step-s", "600"]
    assert train_launch.main(argv) == 0
    out = capsys.readouterr().out
    assert ("done: 4 steps" in out) if carbon else ("final loss" in out)


def test_train_launcher_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launch.main(["--steps", "1"])
