"""The port's layer primitives against the JAX reference's, in float32 on
the CPU, at 1e-6: the same numpy inputs on both sides."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = dict(atol=1e-6, rtol=1e-6)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rmsnorm_matches_reference(eps):
    r = _rng(0)
    x = r.normal(size=(2, 5, 48)).astype(np.float32) * 3
    w = r.normal(size=(48,)).astype(np.float32) * 0.1
    _close(TL.rmsnorm(torch.tensor(x), torch.tensor(w), eps),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps))


def test_layernorm_matches_reference():
    r = _rng(1)
    x = r.normal(size=(3, 4, 40)).astype(np.float32) + 2
    w, b = (r.normal(size=(40,)).astype(np.float32) for _ in range(2))
    _close(TL.layernorm(*map(torch.tensor, (x, w, b))),
           JL.layernorm(*map(jnp.asarray, (x, w, b))))


@pytest.mark.parametrize("positions", ["1d", "2d", "offset"])
def test_rope_matches_reference(positions):
    r = _rng(2)
    x = r.normal(size=(2, 6, 3, 32)).astype(np.float32)
    pos = {"1d": np.arange(6), "offset": np.arange(37, 43),
           "2d": r.integers(0, 64, (2, 6))}[positions].astype(np.int32)
    _close(TL.rope(torch.tensor(x), torch.tensor(pos), 10_000.0),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(variant):
    r = _rng(3)
    x = r.normal(size=(2, 5, 32)).astype(np.float32)
    p = {"wg": r.normal(size=(32, 64)) / 6, "wi": r.normal(size=(32, 64)) / 6,
         "wo": r.normal(size=(64, 32)) / 8}
    if variant == "gelu":
        del p["wg"]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    got = TL.mlp(torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()},
                 variant, torch.float32)
    want = JL.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                  variant, jnp.float32)
    _close(got, want)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "smollm-135m",
                                  "chameleon-34b"])
def test_qkv_project_matches_reference(arch):
    cfg = get_arch(arch).smoke
    ref_cfg = ref_get_arch(arch).smoke
    port = dataclasses.asdict(cfg)
    assert port.pop("ssm_impl") == "auto"       # the port's own SSD switch
    assert port == dataclasses.asdict(ref_cfg)
    r = _rng(4)
    d, dq = cfg.d_model, cfg.n_heads * cfg.head_dim
    dkv = cfg.n_kv_heads * cfg.head_dim
    p = {"wq": r.normal(size=(d, dq)), "wk": r.normal(size=(d, dkv)),
         "wv": r.normal(size=(d, dkv))}
    p = {k: (v / np.sqrt(d)).astype(np.float32) for k, v in p.items()}
    if cfg.qk_norm:                     # chameleon: qk RMSNorm
        p["qnorm"] = r.normal(size=(cfg.head_dim,)).astype(np.float32) * 0.1
        p["knorm"] = r.normal(size=(cfg.head_dim,)).astype(np.float32) * 0.1
    x = r.normal(size=(2, 7, d)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    got = TL.qkv_project(cfg, {k: torch.tensor(v) for k, v in p.items()},
                         torch.tensor(x), torch.tensor(pos))
    want = JL.qkv_project(ref_cfg, {k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jnp.asarray(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_output_project_matches_reference():
    cfg = get_arch("phi4-mini-3.8b").smoke
    r = _rng(5)
    o = r.normal(size=(2, 3, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    w = (r.normal(size=(cfg.n_heads * cfg.head_dim, cfg.d_model)) / 8).astype(
        np.float32)
    _close(TL.output_project(cfg, {"wo": torch.tensor(w)}, torch.tensor(o)),
           JL.output_project(ref_get_arch("phi4-mini-3.8b").smoke,
                             {"wo": jnp.asarray(w)}, jnp.asarray(o)))


@pytest.mark.parametrize("fn", ["silu", "gelu"])
def test_bf16_activations_round_as_the_reference(fn):
    x = _rng(6).normal(size=(4096,)).astype(np.float32) * 3
    got = getattr(TL, fn)(torch.tensor(x).bfloat16()).float().numpy()
    want = np.asarray(getattr(jax.nn, fn)(jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    # the same op sequence: equal but for rare few-ulp differences of the
    # transcendental functions (amplified where GELU's 1 + tanh cancels)
    assert np.mean(got != want) < 0.01
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=4e-3)


def test_bf16_gelu_equals_the_reference_bit_for_bit():
    """GELU's cubic coefficient is a bf16 constant in the reference
    (0.044677734375); used unrounded, one element in ~400 differed by an
    ulp, enough to move RecurrentGemma's bf16 logits past 2e-2."""
    x = _rng(7).normal(size=(100_000,)).astype(np.float32) * 3
    got = TL.gelu(torch.tensor(x).bfloat16()).float().numpy()
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16)), np.float32)
    np.testing.assert_array_equal(got, want)


def test_cast_tree_keeps_tensors_already_in_the_dtype():
    t32, t16 = torch.ones(3), torch.ones(3, dtype=torch.bfloat16)
    out = TL.cast_tree({"a": t32, "b": {"c": t16}}, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16 and out["b"]["c"] is t16
