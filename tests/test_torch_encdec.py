"""The encoder-decoder family (Whisper) against the JAX reference on the
CPU: sinusoidal positions and the decode position row, parameter specs,
counts and caches, the encoder, prefill (self- and cross-attention
caches), decode steps and `ServeEngine.generate` for the smoke config of
whisper-base. The reference's parameters (`Model.init(PRNGKey(0))`) are
carried across by `convert.from_reference_params`; frames, prompts and
tokens are made with numpy from a seed."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import encdec as REF_ENCDEC  # noqa: E402
from repro.models import layers as REF_L  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import from_reference_params  # noqa: E402
from repro_torch.models import encdec as ENCDEC  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "whisper-base"


def _pair(dtype, **kw):
    """The reference model with its PRNGKey(0) parameters, and the port
    model with the same parameters."""
    ref_cfg = dataclasses.replace(ref_get_arch(ARCH).smoke, dtype=dtype, **kw)
    cfg = dataclasses.replace(get_arch(ARCH).smoke, dtype=dtype, **kw)
    ref = ref_get_model(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    params = from_reference_params(cfg, jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref, ref_params, get_model(cfg), params


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _batch(cfg, B, S, seed, dtype=np.float32):
    """(reference batch, port batch): random tokens and frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(dtype)
    return ({"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)},
            {"tokens": torch.tensor(tokens), "frames": torch.tensor(frames)})


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "axes"))
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _assert_cache_close(got, want, tol):
    want_flat = _ref_flat(want)
    got_flat = dict(flatten(got))
    assert set(got_flat) == set(want_flat) == {"k", "v", "ck", "cv", "pos"}
    assert got_flat.pop("pos") == int(want_flat.pop("pos"))
    for path, t in got_flat.items():
        assert tuple(t.shape) == want_flat[path].shape, path
        np.testing.assert_allclose(_np(t), _np(want_flat[path]), err_msg=path,
                                   **tol)


# XLA's CPU exp and sin are not correctly rounded (PyTorch's are within
# an ulp), so a frequency may differ by one ulp (2**-24 relative below
# 1), and an angle of position p by p ulps of it: positions agree within
# ANGLE_ULP * p plus an ulp of the sine
ANGLE_ULP = 2.0 ** -23


def _pos_tol(p):
    return ANGLE_ULP * p + 2.0 ** -22


@pytest.mark.parametrize("seq,d", [(32, 64), (1500, 512), (7, 10)])
def test_sinusoidal_positions_match_reference(seq, d):
    freqs = L.sinusoidal_frequencies(d).numpy()
    half = d // 2
    want_f = np.asarray(jnp.exp(-jnp.log(10000.0) * jnp.arange(half)
                                / (half - 1)))
    np.testing.assert_allclose(freqs, want_f, rtol=2.0 ** -23, atol=0)
    got = L.sinusoidal_positions(seq, d)
    want = np.asarray(REF_L.sinusoidal_positions(seq, d))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want)
    assert (err <= _pos_tol(np.arange(seq))[:, None]).all(), err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_position_row_matches_reference(dtype):
    """The decoder embedding at a decode offset: the reference builds the
    row with its own expression (not a row of `sinusoidal_positions`).
    In bfloat16 the sum may round the other way: one bf16 ulp more."""
    ref, ref_params, model, params = _pair(dtype)
    tok = np.array([[3], [250]], np.int32)
    ulp = 2.0 ** -8 if dtype == "bfloat16" else 0.0
    for offset in (1, 7, 31, 448, 1499):
        want = _np(REF_ENCDEC._decoder_embed(
            ref.cfg, ref_params, jnp.asarray(tok),
            offset=jnp.asarray(offset, jnp.int32)))
        got = _np(ENCDEC._decoder_embed(model.cfg, params, torch.tensor(tok),
                                        offset=offset))
        assert (np.abs(got - want) <= _pos_tol(offset) + ulp * np.abs(want)
                ).all(), (offset, np.abs(got - want).max())
    prompt = np.array([[5, 6, 7, 8]], np.int32)        # a prefill's rows
    want = REF_ENCDEC._decoder_embed(ref.cfg, ref_params, jnp.asarray(prompt))
    got = ENCDEC._decoder_embed(model.cfg, params, torch.tensor(prompt))
    np.testing.assert_allclose(_np(got), _np(want), atol=_pos_tol(4),
                               rtol=ulp)


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_specs_counts_and_caches_match_the_reference(size):
    cfg = getattr(get_arch(ARCH), size)
    ref = ref_get_model(getattr(ref_get_arch(ARCH), size))
    ours = {p: (tuple(s.shape), s.init, s.scale, s.dtype)
            for p, s in flatten(get_model(cfg).specs())}
    theirs = {p: (tuple(s.shape), s.init, s.scale, s.dtype)
              for p, s in _ref_flat(ref.specs()).items()}
    assert ours == theirs
    assert get_model(cfg).param_count() == ref.param_count()
    cache = {p: (tuple(s.shape), s.dtype)
             for p, s in flatten(get_model(cfg).cache_specs(2, 64))}
    ref_cache = {p: (tuple(s.shape), s.dtype)
                 for p, s in _ref_flat(ref.cache_specs(2, 64)).items()}
    assert cache == ref_cache
    if size == "full":
        assert get_model(cfg).param_count() == 70_627_840
        assert cache["ck"][0] == (6, 2, 8, 1500, 64)    # never padded


def test_init_cache_and_loss_fn():
    model = get_model(get_arch(ARCH).smoke)
    cache = model.init_cache(2, 16, device="cpu")
    assert cache["pos"] == 0
    assert tuple(cache["k"].shape) == (2, 2, 4, 16, 16)
    assert tuple(cache["cv"].shape) == (2, 2, 4, 32, 16)
    assert not cache["ck"].any()
    cfg = model.cfg
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 8))),
             "labels": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 8))),
             "frames": torch.tensor(rng.normal(
                 size=(2, cfg.enc_seq, cfg.d_model)), dtype=torch.float32)}
    loss, metrics = ENCDEC.loss_fn(model.cfg, params, batch)
    assert bool(torch.isfinite(loss)) and metrics == {"ce_loss": loss}


def test_encoder_matches_reference():
    ref, ref_params, model, params = _pair("float32")
    jb, tb = _batch(model.cfg, 2, 4, seed=8)
    want = REF_ENCDEC.encode(ref.cfg, ref_params, jb["frames"])
    got = ENCDEC.encode(model.cfg, params, tb["frames"])
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_f32_prefill_caches_and_decode_match_reference():
    ref, ref_params, model, params = _pair("float32")
    jb, tb = _batch(model.cfg, 2, 6, seed=1)
    jl, jc = ref.prefill(ref_params, jb, pad_to=14)
    tl, tc = model.prefill(params, tb, pad_to=14)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    _assert_cache_close(tc, jc, tol)
    for _ in range(8):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(tl, -1).numpy(), tok)
        jl, jc = ref.decode(ref_params, jc, jnp.asarray(tok))
        tl, tc = model.decode(params, tc, torch.tensor(tok))
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    _assert_cache_close(tc, jc, tol)
    with pytest.raises(IndexError, match="cache is full"):
        model.decode(params, tc, torch.zeros(2, dtype=torch.long))


def test_f32_greedy_generation_equals_reference():
    """Through the engines, which feed zero frames."""
    ref, ref_params, model, params = _pair("float32")
    prompts = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (3, 4)).astype(np.int32)
    want = RefEngine(ref, ref_params).generate(prompts, 8)
    got = ServeEngine(model, params, device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for key in ("prefill_tokens", "decode_tokens"):
        assert got["stats"][key] == want["stats"][key]


def test_bf16_logits_match_reference():
    """Against the reference run op by op (``jax.disable_jit``)."""
    ref, ref_params, model, params = _pair("bfloat16")
    jb, tb = _batch(model.cfg, 2, 6, seed=4)
    rng = np.random.default_rng(4)
    with jax.disable_jit():
        jl, jc = ref.prefill(ref_params, jb, pad_to=12)
    tl, tc = model.prefill(params, tb, pad_to=12)
    assert tl.dtype == torch.bfloat16
    steps = [(_np(tl), _np(jl))]
    for _ in range(4):
        tok = rng.integers(0, model.cfg.vocab_size, (2,)).astype(np.int32)
        with jax.disable_jit():
            jl, jc = ref.decode(ref_params, jc, jnp.asarray(tok))
        tl, tc = model.decode(params, tc, torch.tensor(tok))
        steps.append((_np(tl), _np(jl)))
    for got, want in steps:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_decode_consistent_with_forward():
    """logits(prefill S tokens; decode token S) == logits(prefill S+1),
    as `tests/test_archs_smoke.py` holds the reference."""
    cfg = get_arch(ARCH).smoke
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    B, S = 2, 12
    _, full = _batch(cfg, B, S + 1, seed=6)
    full["frames"] = full["frames"].to(torch.bfloat16)
    pre = {"tokens": full["tokens"][:, :S], "frames": full["frames"]}
    _, cache = model.prefill(params, pre, pad_to=S + 4)
    dec, _ = model.decode(params, cache, full["tokens"][:, S])
    want, _ = model.prefill(params, full)
    np.testing.assert_allclose(_np(dec), _np(want), atol=0.1, rtol=0.05)


def test_prepared_params_give_the_same_numbers():
    _, _, model, params = _pair("bfloat16")
    prepared = model.prepare(params)
    for stack in ("enc_layers", "dec_layers"):
        for path, t in flatten(prepared[stack]):
            assert t.dtype == torch.bfloat16, (stack, path)
    for norm in ("enc_norm", "final_norm"):
        assert prepared[norm]["scale"].dtype == torch.float32
    _, tb = _batch(model.cfg, 2, 5, seed=5)
    a, ca = model.prefill(params, tb, pad_to=8)
    b, cb = model.prefill(prepared, tb, pad_to=8)
    assert torch.equal(a, b)
    for name in ("k", "v", "ck", "cv"):
        assert torch.equal(ca[name], cb[name]), name
    tok = torch.argmax(a, -1)
    assert torch.equal(model.decode(params, ca, tok)[0],
                       model.decode(prepared, cb, tok)[0])


def test_prefill_attention_goes_to_the_flash_kernel(monkeypatch):
    """`ops.mha` as it dispatches on the card: the encoder's
    self-attention (non-causal over the frames), the decoder's causal
    self-attention and the cross-attention (Sq != Skv) of a prefill go to
    `flash_attention`; a decode step's single-row calls do not."""
    from repro_torch.kernels import ops
    calls = []
    flash = ops.flash_attention

    def recorder(q, k, v, causal=True, window=0):
        calls.append((q.shape[1], k.shape[1], causal))
        return flash(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(ops, "_on_card", lambda impl, x, op: impl == "auto")
    monkeypatch.setattr(ops, "flash_attention", recorder)
    cfg = get_arch(ARCH).smoke
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    _, tb = _batch(cfg, 2, 4, seed=9)
    _, cache = model.prefill(params, tb, pad_to=6)
    enc, S = cfg.enc_seq, 4
    assert calls == [(enc, enc, False)] * cfg.n_enc_layers + [
        (S, S, True), (S, enc, False)] * cfg.n_layers
    calls.clear()
    model.decode(params, cache, torch.zeros(2, dtype=torch.long))
    assert calls == []
