"""Mamba-2 and RecurrentGemma serving against the JAX reference on the
CPU: parameter specs, counts and initialisers, prefill, the caches,
decode steps (past RecurrentGemma's ring window) and
`ServeEngine.generate`. The reference's parameters
(`Model.init(PRNGKey(0))`) are carried across by
`convert.from_reference_params`; prompts and tokens are made with numpy
from a seed."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import from_reference_params  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten, unflatten  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCHS = ["mamba2-2.7b", "recurrentgemma-9b"]
# (arch, n_layers): the smoke configs, and RecurrentGemma with one
# superlayer and two trailing blocks (the smoke config has no `trail`)
SERVED = [("mamba2-2.7b", 0), ("recurrentgemma-9b", 0),
          ("recurrentgemma-9b", 5)]


def _cfgs(arch, dtype, n_layers=0):
    ref, ours = ref_get_arch(arch).smoke, get_arch(arch).smoke
    kw = dict(dtype=dtype, n_layers=n_layers or ours.n_layers)
    return dataclasses.replace(ref, **kw), dataclasses.replace(ours, **kw)


def _pair(arch, dtype, n_layers=0):
    """The reference model with its PRNGKey(0) parameters, and the port
    model with the same parameters."""
    ref_cfg, cfg = _cfgs(arch, dtype, n_layers)
    ref = ref_get_model(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    params = from_reference_params(cfg, jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref, ref_params, get_model(cfg), params


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "axes"))
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _assert_cache_close(got, want, tol):
    """Every leaf of the port's cache (``pos`` an int) against the
    reference's."""
    want_flat = _ref_flat(want)
    got_flat = dict(flatten(got))
    assert set(got_flat) == set(want_flat)
    assert got_flat.pop("pos") == int(want_flat.pop("pos"))
    for path, t in got_flat.items():
        assert tuple(t.shape) == want_flat[path].shape, path
        np.testing.assert_allclose(_np(t), _np(want_flat[path]), err_msg=path,
                                   **tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_specs_and_counts_match_the_reference(arch, size):
    cfg = getattr(get_arch(arch), size)
    ref = ref_get_model(getattr(ref_get_arch(arch), size))
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


def test_full_width_parameter_counts():
    assert get_model(get_arch("mamba2-2.7b").full).param_count() == (
        2_702_579_200)
    assert get_model(get_arch("recurrentgemma-9b").full).param_count() == (
        9_396_408_320)


def test_ssm_a_and_lru_lambda_initialisers():
    params = get_model(get_arch("mamba2-2.7b").smoke).init(0, device="cpu")
    a_log = params["layers"]["a_log"]
    assert float(a_log.min()) >= 0.0 and float(a_log.max()) < np.log(16.0)
    assert float(a_log.std()) > 0.3                # spread over [0, log 16)
    rg = get_model(get_arch("recurrentgemma-9b").smoke).init(0, device="cpu")
    lam = rg["super"]["rec1"]["lam"].double()
    # a^c = exp(-8 softplus(lam)) is uniform on [0.9, 0.999)
    ac = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert float(ac.min()) >= 0.9 - 1e-6 and float(ac.max()) < 0.999 + 1e-6
    assert not torch.equal(rg["super"]["rec1"]["lam"],
                           rg["super"]["rec2"]["lam"])
    ref = ref_get_model(ref_get_arch("recurrentgemma-9b").smoke)
    ref_lam = np.asarray(ref.init(jax.random.PRNGKey(0))["super"]["rec1"]["lam"])
    ref_ac = np.exp(-8.0 * np.log1p(np.exp(ref_lam.astype(np.float64))))
    assert ref_ac.min() >= 0.9 - 1e-6 and ref_ac.max() < 0.999 + 1e-6


@pytest.mark.parametrize("arch,n_layers", SERVED, ids=str)
def test_f32_prefill_cache_and_decode_match_reference(arch, n_layers):
    ref, ref_params, model, params = _pair(arch, "float32", n_layers)
    V = model.cfg.vocab_size
    prompts = np.random.default_rng(1).integers(0, V, (2, 12)).astype(np.int32)
    jl, jc = ref.prefill(ref_params, {"tokens": jnp.asarray(prompts)})
    tl, tc = model.prefill(params, {"tokens": torch.tensor(prompts)})
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    _assert_cache_close(tc, jc, tol)
    for _ in range(8):              # 12 + 8 > the smoke window of 16
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(tl, -1).numpy(), tok)
        jl, jc = ref.decode(ref_params, jc, jnp.asarray(tok))
        tl, tc = model.decode(params, tc, torch.tensor(tok))
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    _assert_cache_close(tc, jc, tol)


@pytest.mark.parametrize("arch,n_layers", SERVED, ids=str)
def test_bf16_logits_match_reference(arch, n_layers):
    """Against the reference run op by op (``jax.disable_jit``), where
    every bf16 op rounds as it does in the port. Compiled, XLA fuses the
    scanned layers' elementwise ops and may skip their bf16 roundings
    (excess precision), which moves the reference's own RecurrentGemma
    prefill logits by 1.2 % (3 layers) and 1.5 % (5 layers) of their
    maximum against its op-by-op run."""
    ref, ref_params, model, params = _pair(arch, "bfloat16", n_layers)
    rng = np.random.default_rng(4)
    V = model.cfg.vocab_size
    prompts = rng.integers(0, V, (2, 12)).astype(np.int32)
    with jax.disable_jit():
        jl, jc = ref.prefill(ref_params, {"tokens": jnp.asarray(prompts)})
    tl, tc = model.prefill(params, {"tokens": torch.tensor(prompts)})
    assert tl.dtype == torch.bfloat16          # the reference's bf16 logits
    steps = [(_np(tl), _np(jl))]
    for _ in range(8):
        tok = rng.integers(0, V, (2,)).astype(np.int32)
        with jax.disable_jit():
            jl, jc = ref.decode(ref_params, jc, jnp.asarray(tok))
        tl, tc = model.decode(params, tc, torch.tensor(tok))
        steps.append((_np(tl), _np(jl)))
    for got, want in steps:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("arch,n_layers", SERVED, ids=str)
def test_f32_greedy_generation_equals_reference(arch, n_layers):
    ref, ref_params, model, params = _pair(arch, "float32", n_layers)
    prompts = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (3, 16)).astype(np.int32)
    want = RefEngine(ref, ref_params).generate(prompts, 8)
    got = ServeEngine(model, params, device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for key in ("prefill_tokens", "decode_tokens"):
        assert got["stats"][key] == want["stats"][key]


@pytest.mark.parametrize("arch", ARCHS)
def test_prepared_params_give_the_same_numbers(arch):
    _, _, model, params = _pair(arch, "bfloat16")
    prepared = model.prepare(params)
    stack = prepared["layers"] if "layers" in prepared else (
        prepared["super"]["rec1"])
    for name in ("a_log", "d_skip", "dt_bias", "conv_w", "gnorm", "lam"):
        if name in stack:
            assert stack[name].dtype == torch.bfloat16, name
    assert prepared["final_norm"]["scale"].dtype == torch.float32
    tokens = torch.tensor(np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (2, 10)))
    a, ca = model.prefill(params, {"tokens": tokens})
    b, cb = model.prefill(prepared, {"tokens": tokens})
    assert torch.equal(a, b)
    tok = torch.argmax(a, -1)
    assert torch.equal(model.decode(params, ca, tok)[0],
                       model.decode(prepared, cb, tok)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_prefill_launches_no_kernel_and_init_cache(arch):
    model = get_model(get_arch(arch).smoke)
    params = model.init(0, device="cpu")
    before = (ssd_scan.launches, rglru_scan.launches)
    logits, cache = model.prefill(params, {"tokens": torch.zeros(
        2, 16, dtype=torch.long)})
    assert (ssd_scan.launches, rglru_scan.launches) == before
    assert bool(torch.isfinite(logits.float()).all())
    empty = model.init_cache(2, 64, device="cpu")
    assert empty["pos"] == 0 and cache["pos"] == 16
    shapes = lambda c: {p: tuple(t.shape) for p, t in flatten(c)
                        if p != "pos"}
    assert shapes(empty) == shapes(cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_from_reference_params_checks_both_families(arch):
    cfg = get_arch(arch).smoke
    specs = get_model(cfg).specs()
    nested = unflatten(specs, {p: np.zeros(s.shape, np.float32)
                               for p, s in flatten(specs)})
    out = from_reference_params(cfg, nested, device="cpu")
    assert dict(flatten(out)).keys() == dict(flatten(specs)).keys()
    path, spec = flatten(specs)[-1]
    leaf = nested
    for key in path.split("/")[:-1]:
        leaf = leaf[key]
    leaf[path.split("/")[-1]] = np.zeros((3,) + tuple(spec.shape), np.float32)
    with pytest.raises(ValueError, match=f"{path}: shape"):
        from_reference_params(cfg, nested, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    before = (ssd_scan.launches, rglru_scan.launches)
    assert serve_launch.main(["--arch", arch, "--device", "cpu", "--batch",
                              "2", "--prompt-len", "16",
                              "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens, 0 flash kernel launches, 0 ssd_scan, " \
        "0 rglru_scan" in out
    assert (ssd_scan.launches, rglru_scan.launches) == before
