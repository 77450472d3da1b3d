"""The readers of the program's spans and counter (`repro_torch.spans`):
on a record built by hand, a device event counts where its launch, on
any thread, falls inside a span of the window's thread, and not outside
one; nothing to read gives None. Then the program's own spans, seen by
the benchmark's `Tracer` around a CPU training step."""
from __future__ import annotations

import pytest
import torch

import portbench_cases
from portbench import harness
from portbench.trace import Record, Tracer

MAIN, WORKER = 11, 12           # the window's thread, autograd's worker
SPAN_READERS = {                # reader -> (span, value of the record below)
    "forward_ms.train": ("train.forward", 1000.0 * 5e-6 / 2),
    "backward_ms.train": ("train.backward", 1000.0 * 5e-6 / 2),
    "optimizer_ms.train": ("train.optimizer", 1000.0 * 5e-6 / 2),
    "prefill_ms.serve": ("serve.prefill", 1000.0 * 5e-6 / 2),
    "decode_launches.serve": ("serve.decode", 2 / 2),
}


def reader(name):
    mod = harness.load_module(harness.BENCH / "metrics" / f"{name}.py")
    spec = [m for m in portbench_cases.manifest()["per_layer"]
            if m["name"] == name]
    assert [(mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES)] == [
        (m["name"], m["unit"], m["layer"], m["moves"]) for m in spec]
    return mod


def record(span: str, device: bool = True, spans: bool = True) -> Record:
    """Two spans `span` (0-100 and 200-300 ns) on the window's thread and
    three device events of 2, 3 and 7 us: the first launched by the worker
    inside the first span, the second by the window's thread inside the
    second (by its linked correlation), the third between the spans."""
    rec = Record.__new__(Record)
    rec.t0, rec.t1, rec.main, rec.ctx, rec.calls = 0, 1_000, MAIN, {}, {}
    ops = [(0, 1_000, "portbench.window")]
    if spans:
        ops += [(0, 100, span), (10, 90, "aten::mm"), (200, 300, span)]
    rec.ops = {MAIN: sorted(ops)}
    rec._starts = {t: [o[0] for o in v] for t, v in rec.ops.items()}
    rec.launches = {1: (50, WORKER), 2: (250, MAIN), 3: (150, WORKER)}
    rec.device = sorted([(400, 2_400, "k1", 1, 0), (2_500, 5_500, "k2", 9, 2),
                         (6_000, 13_000, "k3", 3, 0)]) if device else []
    return rec


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_reader_counts_launches_inside_its_spans(name):
    span, want = SPAN_READERS[name]
    mod = reader(name)
    assert mod.read(record(span)) == pytest.approx(want)
    assert mod.read(record("other.span")) is None
    assert mod.read(record(span, spans=False)) is None
    assert mod.read(record(span, device=False)) is None


def test_alloc_retries_per_step(monkeypatch):
    from repro_torch import spans
    mod = reader("alloc_retries.train")
    monkeypatch.setattr(spans, "COUNTS", {})
    assert mod.read(record("train.step")) is None       # no counter read
    spans.COUNTS["train.alloc_retries"] = 3
    assert mod.read(record("train.step")) == 1.5
    assert mod.read(record("train.step", device=False)) is None
    assert mod.read(record("train.step", spans=False)) is None
    spans.COUNTS["train.alloc_retries"] = 0
    assert mod.read(record("train.step")) == 0.0


def test_tracer_sees_the_programs_spans(tmp_path):
    """A CPU `ElasticJob` step under the benchmark's `Tracer`: its spans
    are host operations of the window's thread, nested in the step; on
    the CPU no device event falls in them, so every reader gives None."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_arch
    from repro_torch.core.elastic import ElasticJob
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.api import get_model
    cfg = get_arch("smollm-135m").smoke
    job = ElasticJob(get_model(cfg), TrainConfig(
        seq_len=16, global_batch=4, microbatch=2), str(tmp_path))
    job.start(["cpu"])
    batch = next(iter(SyntheticLM(cfg.vocab_size, 16, 4, seed=5)))
    tracer = Tracer("cpu")
    with tracer:
        job.train_step(batch)
    rec = tracer.record
    (step,) = rec.spans("train.step")
    inner = {n: rec.spans(n) for n in
             ("train.forward", "train.backward", "train.optimizer")}
    assert [len(v) for v in inner.values()] == [2, 2, 1]
    assert all(rec.t0 <= step[0] <= s < e <= step[1] <= rec.t1
               for v in inner.values() for s, e in v)
    for name in list(SPAN_READERS) + ["alloc_retries.train"]:
        assert reader(name).read(rec) is None
