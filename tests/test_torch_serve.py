"""The serving slice as a whole against the JAX reference, on the CPU:
configs, parameter specs and counts, prefill, the KV cache, decode steps
and `ServeEngine.generate` for the smoke configs of phi4-mini-3.8b and
smollm-135m; every architecture served on the CPU, and the launcher.
The reference's parameters (`Model.init(PRNGKey(0))`) are carried
across by `convert.from_reference_params`; prompts and tokens are made
with numpy from a seed."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402

from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.convert import from_reference_params  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten, unflatten  # noqa: E402
from repro_torch.serve.engine import (ServeEngine,  # noqa: E402
                                      throughput_tokens_per_s)

SERVED = ["phi4-mini-3.8b", "smollm-135m"]


def _pair(arch, dtype):
    """The smoke config in `dtype`, the reference model with its
    PRNGKey(0) parameters, and the port model with the same parameters."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke, dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=dtype)
    ref = ref_get_model(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    params = from_reference_params(cfg, jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref, ref_params, get_model(cfg), params


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_configs_are_copies_of_the_reference(arch):
    spec, ref = get_arch(arch), ref_get_arch(arch)
    assert (spec.source, dict(spec.skip_shapes)) == (ref.source,
                                                     dict(ref.skip_shapes))
    for a, b in ((spec.full, ref.full), (spec.smoke, ref.smoke)):
        port = dataclasses.asdict(a)
        assert port.pop("ssm_impl") == "auto"   # the port's own SSD switch
        assert port == dataclasses.asdict(b)
        assert a.param_count() == b.param_count()
    assert sorted(ARCHS) == sorted(REF_ARCHS)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "smollm-135m",
                                  "starcoder2-7b", "chameleon-34b",
                                  "olmoe-1b-7b", "dbrx-132b", "whisper-base"])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_dense_specs_match_the_reference(arch, size):
    """The dense family's spec trees, and those of the MoE (the ``moe``
    subtree in place of ``mlp``) and encoder-decoder families."""
    cfg = getattr(get_arch(arch), size)
    ref = ref_get_model(getattr(ref_get_arch(arch), size))
    ours = {p: (tuple(s.shape), s.init, s.scale, s.dtype)
            for p, s in flatten(get_model(cfg).specs())}
    ref_flat, _ = jax.tree_util.tree_flatten_with_path(
        ref.specs(), is_leaf=lambda x: hasattr(x, "axes"))
    theirs = {"/".join(str(k.key) for k in path):
              (tuple(s.shape), s.init, s.scale, s.dtype)
              for path, s in ref_flat}
    assert ours == theirs
    assert get_model(cfg).param_count() == ref.param_count()


@pytest.mark.parametrize("arch", SERVED)
def test_f32_prefill_cache_and_decode_match_reference(arch):
    ref, ref_params, model, params = _pair(arch, "float32")
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    prompts = rng.integers(0, V, (2, 24)).astype(np.int32)
    jl, jc = ref.prefill(ref_params, {"tokens": jnp.asarray(prompts)},
                         pad_to=30)
    tl, tc = model.prefill(params, {"tokens": torch.tensor(prompts)},
                           pad_to=30)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    assert tc["pos"] == int(jc["pos"]) == 24
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **tol)
    for _ in range(4):
        tok = rng.integers(0, V, (2,)).astype(np.int32)
        jl, jc = ref.decode(ref_params, jc, jnp.asarray(tok))
        tl, tc = model.decode(params, tc, torch.tensor(tok))
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)
        assert tc["pos"] == int(jc["pos"])
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **tol)


@pytest.mark.parametrize("arch", SERVED)
def test_f32_greedy_generation_equals_reference(arch):
    ref, ref_params, model, params = _pair(arch, "float32")
    prompts = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (3, 16)).astype(np.int32)
    want = RefEngine(ref, ref_params).generate(prompts, 8)
    got = ServeEngine(model, params, device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens"].dtype == np.int32
    assert set(got["stats"]) == set(want["stats"])
    for key in ("prefill_tokens", "decode_tokens"):
        assert got["stats"][key] == want["stats"][key]


@pytest.mark.parametrize("arch", SERVED)
def test_generation_stops_at_eos_as_reference(arch):
    ref, ref_params, model, params = _pair(arch, "float32")
    prompts = np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (2, 12)).astype(np.int32)
    first = RefEngine(ref, ref_params).generate(prompts, 4)["tokens"]
    eos = int(first[0, 1])
    want = RefEngine(ref, ref_params).generate(prompts, 6, eos_id=eos)
    got = ServeEngine(model, params, device="cpu").generate(prompts, 6,
                                                            eos_id=eos)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("arch", SERVED)
def test_bf16_logits_match_reference(arch):
    ref, ref_params, model, params = _pair(arch, "bfloat16")
    rng = np.random.default_rng(4)
    V = model.cfg.vocab_size
    prompts = rng.integers(0, V, (2, 24)).astype(np.int32)
    jl, jc = ref.prefill(ref_params, {"tokens": jnp.asarray(prompts)},
                         pad_to=28)
    tl, tc = model.prefill(params, {"tokens": torch.tensor(prompts)},
                           pad_to=28)
    assert tl.dtype == torch.bfloat16          # the reference's bf16 logits
    steps = [(_np(tl), _np(jl))]
    for _ in range(4):
        tok = rng.integers(0, V, (2,)).astype(np.int32)
        jl, jc = ref.decode(ref_params, jc, jnp.asarray(tok))
        tl, tc = model.decode(params, tc, torch.tensor(tok))
        steps.append((_np(tl), _np(jl)))
    for got, want in steps:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_prepared_params_give_the_same_numbers():
    _, _, model, params = _pair("phi4-mini-3.8b", "bfloat16")
    prepared = model.prepare(params)
    assert prepared["layers"]["ln1"]["scale"].dtype == torch.bfloat16
    assert prepared["final_norm"]["scale"].dtype == torch.float32
    tokens = torch.tensor(np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (2, 10)))
    a, ca = model.prefill(params, {"tokens": tokens}, pad_to=12)
    b, cb = model.prefill(prepared, {"tokens": tokens}, pad_to=12)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])
    tok = torch.argmax(a, -1)
    assert torch.equal(model.decode(params, ca, tok)[0],
                       model.decode(prepared, cb, tok)[0])


def test_decode_past_the_cache_raises():
    _, _, model, params = _pair("smollm-135m", "float32")
    _, cache = model.prefill(params, {"tokens": torch.zeros(1, 4,
                                                            dtype=torch.long)})
    with pytest.raises(IndexError, match="cache is full"):
        model.decode(params, cache, torch.zeros(1, dtype=torch.long))


def test_sampling_is_reproducible_with_a_generator():
    _, _, model, params = _pair("smollm-135m", "float32")
    eng = ServeEngine(model, params, device="cpu")
    prompts = np.zeros((2, 5), np.int32)
    a = eng.generate(prompts, 5, greedy=False,
                     generator=torch.Generator().manual_seed(7))["tokens"]
    b = eng.generate(prompts, 5, greedy=False,
                     generator=torch.Generator().manual_seed(7))["tokens"]
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < model.cfg.vocab_size
    tp = throughput_tokens_per_s(eng.stats)
    assert tp["prefill_tok_s"] > 0 and tp["decode_tok_s"] > 0


def test_init_params_is_seeded_per_leaf():
    model = get_model(get_arch("phi4-mini-3.8b").smoke)
    a, b = model.init(0, device="cpu"), model.init(0, device="cpu")
    c = model.init(torch.Generator().manual_seed(1), device="cpu")
    for (pa, ta), (_, tb), (_, tc) in zip(flatten(a), flatten(b), flatten(c)):
        assert torch.equal(ta, tb), pa
        if "scale" in pa:                       # norms start at zero
            assert not ta.any()
        else:
            assert not torch.equal(ta, tc), pa
    wq = a["layers"]["attn"]["wq"]               # normal / sqrt(fan_in)
    assert abs(float(wq.std()) * np.sqrt(wq.shape[-2]) - 1.0) < 0.1
    assert abs(float(a["embed"].std()) / 0.02 - 1.0) < 0.1
    cache = model.init_cache(2, 8, device="cpu")
    assert cache["pos"] == 0 and tuple(cache["k"].shape) == (
        2, 2, 2, 8, model.cfg.head_dim)


def test_from_reference_params_checks_shapes_and_paths():
    cfg = get_arch("smollm-135m").smoke
    specs = get_model(cfg).specs()
    nested = unflatten(specs, {p: np.zeros(s.shape, np.float32)
                               for p, s in flatten(specs)})
    out = from_reference_params(cfg, nested, device="cpu")
    assert out["embed"].dtype == torch.float32
    nested["embed"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="embed: shape"):
        from_reference_params(cfg, nested, device="cpu")
    del nested["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        from_reference_params(cfg, nested, device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model(get_arch("smollm-135m").smoke)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_launch.main(["--arch", "smollm-135m"])
    assert ServeEngine(model, device="cpu").load(0).params is not None


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_architecture_serves_on_the_cpu(arch):
    """Each of the ten configurations builds, inits on the CPU and
    serves a few greedy tokens (an encoder-decoder on zero frames)."""
    model = get_model(get_arch(arch).smoke)
    engine = ServeEngine(model, device="cpu").load(0)
    prompts = np.random.default_rng(8).integers(
        0, model.cfg.vocab_size, (2, 6)).astype(np.int32)
    out = engine.generate(prompts, 3)
    assert out["tokens"].shape == (2, 3) and out["tokens"].dtype == np.int32
    assert out["tokens"].min() >= 0
    assert out["tokens"].max() < model.cfg.vocab_size
    assert out["stats"]["prefill_tokens"] == 12
    assert out["stats"]["decode_tokens"] == 6


def test_serve_launcher_runs_on_the_cpu(capsys):
    before = flash_attention.launches
    assert serve_launch.main(["--arch", "smollm-135m", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "8",
                              "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens, 0 flash kernel launches" in out
    assert flash_attention.launches == before


@pytest.mark.parametrize("arch", ["whisper-base", "olmoe-1b-7b"])
def test_serve_launcher_serves_the_new_families_on_the_cpu(arch, capsys):
    before = flash_attention.launches
    assert serve_launch.main(["--arch", arch, "--device", "cpu", "--batch",
                              "2", "--prompt-len", "5", "--new-tokens",
                              "4"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu: generated (2, 4) tokens, 0 flash kernel " \
        "launches" in out
    assert flash_attention.launches == before
