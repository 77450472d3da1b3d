"""The MoE family against the JAX reference on the CPU: the router, the
capacity-bounded dispatch and combine (`moe_apply`, with and without
dropped tokens), parameter specs, counts and initialisers, prefill, the
KV cache, decode steps and `ServeEngine.generate` for the smoke configs
of olmoe-1b-7b and dbrx-132b. The reference's parameters
(`Model.init(PRNGKey(0))`) are carried across by
`convert.from_reference_params`; hidden states, prompts and tokens are
made with numpy from a seed."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import moe as REF_MOE  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import from_reference_params  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCHS = ["olmoe-1b-7b", "dbrx-132b"]


def _cfgs(arch, dtype, **kw):
    ref, ours = ref_get_arch(arch).smoke, get_arch(arch).smoke
    return (dataclasses.replace(ref, dtype=dtype, **kw),
            dataclasses.replace(ours, dtype=dtype, **kw))


def _pair(arch, dtype, **kw):
    """The reference model with its PRNGKey(0) parameters, and the port
    model with the same parameters."""
    ref_cfg, cfg = _cfgs(arch, dtype, **kw)
    ref = ref_get_model(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    params = from_reference_params(cfg, jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref, ref_params, get_model(cfg), params


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _hidden(cfg, B, S, seed):
    """Hidden states with a shared direction, so that the router favours
    some experts (as trained hidden states do) and capacity binds."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model)) + 1.5 * rng.normal(
        size=cfg.d_model)
    return x.astype(np.float32)


def _kept(dispatch_combine, k, T, D, ones, one_hot):
    """The kept mask (T, k), read through a dispatch-and-combine function
    itself: tokens of ones, the identity as the expert FFN and routing
    weight 1 on choice j only give y[:, 0] = keep[:, j]."""
    cols = [np.asarray(dispatch_combine(ones((T, D)), one_hot(j))[0])[:, 0]
            for j in range(k)]
    return np.stack(cols, axis=1) == 1.0


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, cf):
    ref, ref_params, model, params = _pair(arch, "float32",
                                           capacity_factor=cf)
    cfg = model.cfg
    x = _hidden(cfg, 2, 48, seed=11)
    ref_p = jax.tree.map(lambda a: a[0], ref_params["layers"]["moe"])
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    jy, jaux = REF_MOE.moe_apply(ref.cfg, ref_p, jnp.asarray(x))
    ty, taux = MOE.moe_apply(cfg, p, torch.tensor(x))
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    assert float(taux["router_dropped"]) == float(jaux["router_dropped"])
    want_lb = float(jaux["lb_loss"])
    assert abs(float(taux["lb_loss"]) - want_lb) <= 1e-6 * abs(want_lb)
    if cf == 1.25:
        assert float(jaux["router_dropped"]) > 0.0    # capacity binds
    else:
        assert float(jaux["router_dropped"]) == 0.0

    # routing and the kept mask, exactly
    T, D, k = 2 * 48, cfg.d_model, cfg.top_k
    jw, jids, _ = REF_MOE._route(ref.cfg, ref_p["router"],
                                 jnp.asarray(x.reshape(T, D)))
    tw, tids, _ = MOE._route(cfg, p["router"], torch.tensor(x.reshape(T, D)))
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    capacity = MOE._capacity(T, k, cfg.n_experts, cf)
    choice = np.eye(k, dtype=np.float32)
    want = _kept(lambda x, w: REF_MOE._dispatch_combine_local(
        ref.cfg, x, jids, w, 0, cfg.n_experts, capacity, lambda b: b),
        k, T, D, lambda s: jnp.ones(s, jnp.float32),
        lambda j: jnp.asarray(choice[[j] * T]))
    got = _kept(lambda x, w: MOE._dispatch_combine_local(
        cfg, x, tids, w, capacity, lambda b: b),
        k, T, D, torch.ones, lambda j: torch.tensor(choice[[j] * T]))
    assert np.array_equal(got, want)
    assert np.array_equal(MOE._slots(tids, cfg.n_experts, capacity)[0]
                          .numpy(), want)
    assert want.all() == (cf == 8.0)
    assert 1.0 - want.mean() == pytest.approx(float(jaux["router_dropped"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_buffer_is_exact_with_drops(arch):
    """The accumulating scatter into the capacity buffers equals a plain
    assignment of the kept tokens bit for bit: every (expert, slot) has
    at most one kept assignment, and dropped ones add zeros."""
    _, cfg = _cfgs(arch, "bfloat16", capacity_factor=1.0)
    p = get_model(cfg).init(3, device="cpu")["layers"]["moe"]
    x = torch.tensor(_hidden(cfg, 2, 40, seed=5)).to(torch.bfloat16)
    x_flat = x.reshape(-1, cfg.d_model)
    _, ids, _ = MOE._route(cfg, p["router"][0], x_flat)
    T, E = x_flat.shape[0], cfg.n_experts
    capacity = MOE._capacity(T, cfg.top_k, E, cfg.capacity_factor)
    seen = []
    MOE._dispatch_combine_local(cfg, x_flat, ids, torch.ones(ids.shape),
                                capacity,
                                lambda buf: seen.append(buf.clone()) or buf)
    keep, slot = MOE._slots(ids, E, capacity)
    assert not keep.all()                            # some tokens dropped
    cells = ids[keep] * capacity + slot[keep]
    assert cells.unique().numel() == cells.numel()   # one token a cell
    want = torch.zeros((E, capacity, cfg.d_model), dtype=torch.bfloat16)
    tok = torch.arange(T)[:, None].expand_as(ids)
    want[ids[keep], slot[keep]] = x_flat[tok[keep]]
    assert torch.equal(seen[0], want)


def test_router_logits_are_float32_and_ties_go_to_the_lower_expert():
    _, cfg = _cfgs("olmoe-1b-7b", "bfloat16")
    ref_cfg, _ = _cfgs("olmoe-1b-7b", "bfloat16")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, cfg.d_model)).astype(np.float32)
    router = rng.normal(size=(cfg.d_model, cfg.n_experts)).astype(np.float32)
    router[:, 5] = router[:, 2]                      # experts 2 and 5 tie
    router[:, 7] = router[:, 0]                      # so do 0 and 7
    xb = torch.tensor(x).to(torch.bfloat16)
    jw, jids, jp = REF_MOE._route(ref_cfg, jnp.asarray(router),
                                  jnp.asarray(x, jnp.bfloat16))
    tw, tids, tp = MOE._route(cfg, torch.tensor(router), xb)
    assert tp.dtype == torch.float32 and tw.dtype == torch.float32
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    tied = (tids == 2) | (tids == 5)
    both = tied.sum(-1) == 2
    assert both.any()
    pos2 = (tids == 2).float().argmax(-1)
    pos5 = (tids == 5).float().argmax(-1)
    assert bool((pos2[both] < pos5[both]).all())


@pytest.mark.parametrize("tokens,k,E,cf", [(8192, 8, 64, 1.25),
                                           (8192, 4, 16, 1.25),
                                           (4, 8, 64, 1.25), (96, 2, 8, 8.0),
                                           (7, 3, 5, 0.7)])
def test_capacity_is_the_references(tokens, k, E, cf):
    assert MOE._capacity(tokens, k, E, cf) == REF_MOE._capacity(tokens, k, E,
                                                                cf)
    if (tokens, k, E) == (8192, 8, 64):
        assert MOE._capacity(tokens, k, E, cf) == 1281   # OLMoE's prefill


def test_parameter_counts_and_expert_initialisers():
    assert get_model(get_arch("olmoe-1b-7b").full).param_count() == (
        6_919_096_320)
    dbrx = dataclasses.replace(get_arch("dbrx-132b").full, n_layers=2)
    ref_dbrx = dataclasses.replace(ref_get_arch("dbrx-132b").full, n_layers=2)
    assert get_model(dbrx).param_count() == 7_751_301_120 == (
        ref_get_model(ref_dbrx).param_count())
    # 3-D experts' leaves: normal / sqrt(fan_in), fan_in = shape[-2]: D for
    # wg and wi (E, D, F), F for wo (E, F, D)
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b").smoke, d_model=64,
                              d_ff=512)
    moe = get_model(cfg).init(0, device="cpu")["layers"]["moe"]
    for name, fan_in in (("wg", 64), ("wi", 64), ("wo", 512), ("router", 64)):
        std = float(moe[name].std()) * np.sqrt(fan_in)
        assert abs(std - 1.0) < 0.05, (name, std)
    assert not torch.equal(moe["wg"], moe["wi"])


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_greedy_generation_equals_reference(arch):
    ref, ref_params, model, params = _pair(arch, "float32")
    prompts = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (3, 16)).astype(np.int32)
    want = RefEngine(ref, ref_params).generate(prompts, 8)
    got = ServeEngine(model, params, device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for key in ("prefill_tokens", "decode_tokens"):
        assert got["stats"][key] == want["stats"][key]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_reference(arch):
    """Against the reference run op by op (``jax.disable_jit``), where
    every bf16 op rounds as it does in the port."""
    ref, ref_params, model, params = _pair(arch, "bfloat16")
    rng = np.random.default_rng(4)
    V = model.cfg.vocab_size
    prompts = rng.integers(0, V, (2, 24)).astype(np.int32)
    with jax.disable_jit():
        jl, jc = ref.prefill(ref_params, {"tokens": jnp.asarray(prompts)},
                             pad_to=28)
    tl, tc = model.prefill(params, {"tokens": torch.tensor(prompts)},
                           pad_to=28)
    assert tl.dtype == torch.bfloat16
    steps = [(_np(tl), _np(jl))]
    for _ in range(4):
        tok = rng.integers(0, V, (2,)).astype(np.int32)
        with jax.disable_jit():
            jl, jc = ref.decode(ref_params, jc, jnp.asarray(tok))
        tl, tc = model.decode(params, tc, torch.tensor(tok))
        steps.append((_np(tl), _np(jl)))
    for got, want in steps:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consistent_with_forward(arch):
    """logits(prefill S tokens; decode token S) == logits(prefill S+1),
    as `tests/test_archs_smoke.py` holds the reference; a generous
    capacity factor, so that no token drops in either."""
    _, cfg = _cfgs(arch, "bfloat16", capacity_factor=8.0)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    B, S = 2, 12
    full = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, S + 1)))
    _, cache = model.prefill(params, {"tokens": full[:, :S]}, pad_to=S + 4)
    dec, _ = model.decode(params, cache, full[:, S])
    want, _ = model.prefill(params, {"tokens": full})
    np.testing.assert_allclose(_np(dec), _np(want), atol=0.1, rtol=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_prepared_params_give_the_same_numbers(arch):
    _, _, model, params = _pair(arch, "bfloat16")
    prepared = model.prepare(params)
    for path, t in flatten(prepared["layers"]):
        assert t.dtype == torch.bfloat16, path
    assert prepared["final_norm"]["scale"].dtype == torch.float32
    tokens = torch.tensor(np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (2, 10)))
    a, ca = model.prefill(params, {"tokens": tokens}, pad_to=12)
    b, cb = model.prefill(prepared, {"tokens": tokens}, pad_to=12)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])
    tok = torch.argmax(a, -1)
    assert torch.equal(model.decode(params, ca, tok)[0],
                       model.decode(prepared, cb, tok)[0])
