"""The port's spans and counters (`repro_torch.spans`) on the CPU: no-ops
without a profiler; under one, the train step's and the serving
engine's spans on the calling thread, nested and in order; the same
tokens, losses and counters with the profiler on and off."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.config import TrainConfig
from repro_torch.configs import get_arch
from repro_torch.core.elastic import ElasticJob
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.api import get_model
from repro_torch.models.params import flatten
from repro_torch.serve.engine import ServeEngine

NAMES = {"train.step", "train.forward", "train.backward", "train.optimizer",
         "serve.prefill", "serve.decode"}


def _profiled(fn):
    """(fn(), [(start, end, name)] of the spans on the calling thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.caller"):
            out = fn()
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
               e.start_thread_id())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU]
    caller = [t for _, _, n, t in events if n == "test.caller"]
    assert len(caller) == 1
    mine = sorted((s, e, n) for s, e, n, t in events
                  if n in NAMES and t == caller[0])
    assert len(mine) == sum(n in NAMES for *_, n, _ in events)
    return out, mine


def test_no_profiler_no_span_no_count():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("train.step") is spans.span("serve.decode")
    with spans.span("train.step"):
        pass
    before = dict(spans.COUNTS)
    spans.count("train.alloc_retries", 3)
    assert spans.COUNTS == before


def test_counts_only_while_recording():
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            spans.count("test.count", 2)
            spans.count("test.count", 0)
        spans.count("test.count", 5)
        assert spans.COUNTS == {"test.count": 2}
    finally:
        spans.reset()
    assert spans.COUNTS == {}


def _job(tmp, microbatch):
    cfg = get_arch("smollm-135m").smoke
    job = ElasticJob(get_model(cfg), TrainConfig(
        seq_len=16, global_batch=4, microbatch=microbatch), tmp)
    job.start(["cpu"])
    data = iter(SyntheticLM(cfg.vocab_size, 16, 4, seed=3))
    return job, [next(data) for _ in range(2)]


@pytest.mark.parametrize("microbatch,n_micro", [(2, 2), (4, 1)])
def test_train_step_spans_nest_in_order(tmp_path, microbatch, n_micro):
    job, batches = _job(str(tmp_path / "a"), microbatch)
    twin, _ = _job(str(tmp_path / "b"), microbatch)
    want = [twin.train_step(b) for b in batches]
    got = [job.train_step(batches[0])]
    counts = dict(spans.COUNTS)
    out, mine = _profiled(lambda: job.train_step(batches[1]))
    got.append(out)
    assert got == want                      # losses, norms and lr alike
    assert spans.COUNTS == counts           # no allocator counter on the CPU
    left, right = dict(flatten(job.state)), dict(flatten(twin.state))
    assert set(left) == set(right)
    assert all(torch.equal(t, right[p]) for p, t in left.items())
    names = [n for *_, n in mine]
    assert names == (["train.step"]
                     + ["train.forward", "train.backward"] * n_micro
                     + ["train.optimizer"])
    (s0, e0, _), inner = mine[0], mine[1:]
    assert all(s0 <= s < e <= e0 for s, e, _ in inner)
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))


def test_generate_spans_and_same_tokens():
    cfg = get_arch("smollm-135m").smoke
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    plain = ServeEngine(model, params, device="cpu")
    traced = ServeEngine(model, params, device="cpu")
    want = plain.generate(prompts, 3)
    got, mine = _profiled(lambda: traced.generate(prompts, 3))
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert set(got["stats"]) == set(want["stats"]) == {
        "prefill_tokens", "decode_tokens", "prefill_s", "decode_s"}
    for key in ("prefill_tokens", "decode_tokens"):
        assert got["stats"][key] == want["stats"][key]
    assert [n for *_, n in mine] == ["serve.prefill"] + ["serve.decode"] * 3
    assert all(a[1] <= b[0] for a, b in zip(mine, mine[1:]))
