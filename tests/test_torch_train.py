"""The training slice against the JAX reference, on the CPU: the
optimizer and its schedules, gradient compression, the data generators,
the dense and MoE losses and their gradients, the chunked cross-entropy,
rematerialization, the flash attention with its recomputing backward,
train steps (microbatched, int8 and top-k compressed) and checkpoints
read both ways. The reference's parameters (`Model.init(PRNGKey(0))`)
and train states are carried across by `convert`; every other input is
made with numpy from a seed. Tolerances are stated in each test."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.config import OptimizerConfig as RefOptCfg  # noqa: E402
from repro.config import TrainConfig as RefTrainCfg  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.data import pipeline as REF_DATA  # noqa: E402
from repro.kernels import ref as REF_K  # noqa: E402
from repro.models import transformer as REF_T  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.train import checkpoint as REF_CKPT  # noqa: E402
from repro.train import compression as REF_COMP  # noqa: E402
from repro.train import loop as REF_TL  # noqa: E402
from repro.train import optimizer as REF_OPT  # noqa: E402

from repro_torch.config import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import (from_reference_params,  # noqa: E402
                                 from_reference_state)
from repro_torch.data import pipeline as DATA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as K  # noqa: E402
from repro_torch.kernels.flash_attention import (FlashAttentionFn,  # noqa: E402
                                                 flash_attention)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten, tree_map  # noqa: E402
from repro_torch.train import checkpoint as CKPT  # noqa: E402
from repro_torch.train import compression as COMP  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402
from repro_torch.train import optimizer as OPT  # noqa: E402

TRAINED = ["smollm-135m", "olmoe-1b-7b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    """max |got - want| / max(max |want|, 1e-30)."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_trees(got, want, tol, what):
    """Every leaf of `got` (port) within `tol` of `want` (reference),
    relative to the leaf's max |want|; the same paths on both sides."""
    g = dict(flatten(got))
    w = dict(flatten(jax.tree.map(np.asarray, want)))
    assert set(g) == set(w), what
    worst = {p: _rel(g[p], w[p]) for p in w}
    bad = {p: e for p, e in worst.items() if e > tol}
    assert not bad, f"{what}: {bad}"


SHAPES = {"a": (7, 5), "b": (33,), "c": {"d": (4, 3, 2)}}


def _tree(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.normal(size=s).astype(np.float32)
    return make(shapes)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# Optimizer and compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_lr_at_equals_the_reference(schedule, warmup):
    """Every step of the schedule within 1e-6 relative (float32)."""
    kw = dict(lr=3e-3, warmup_steps=warmup, total_steps=110,
              schedule=schedule)
    ours, ref = OptimizerConfig(**kw), RefOptCfg(**kw)
    for step in [0, 1, 5, 9, 10, 11, 37, 60, 109, 110, 150]:
        got = float(OPT.lr_at(ours, torch.tensor(step, dtype=torch.int32)))
        want = float(REF_OPT.lr_at(ref, jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30), (step, got,
                                                                  want)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_update_equals_the_reference(name, clip):
    """Three updates of AdamW / SGD (with and without the global-norm
    clip): params, m, v, grad_norm and lr within 1e-6 relative."""
    kw = dict(name=name, lr=0.05, warmup_steps=2, total_steps=10,
              grad_clip=clip, weight_decay=0.1)
    ours, ref = OptimizerConfig(**kw), RefOptCfg(**kw)
    update, ref_update = OPT.UPDATES[name], REF_OPT.UPDATES[name]
    p, rp = _torch(_tree(0)), _jnp(_tree(0))
    opt, ropt = OPT.adamw_init(p), REF_OPT.adamw_init(rp)
    for step in range(3):
        g = _tree(10 + step)
        p, opt, met = update(ours, _torch(g), opt, p,
                             torch.tensor(step, dtype=torch.int32))
        rp, ropt, rmet = ref_update(ref, _jnp(g), ropt, rp,
                                    jnp.asarray(step, jnp.int32))
        _assert_trees(p, rp, 1e-6, f"params after step {step}")
        _assert_trees(opt, ropt, 1e-6, f"opt after step {step}")
        for k in ("grad_norm", "lr"):
            assert _rel(met[k], rmet[k]) <= 1e-6, k


def test_clip_by_global_norm_equals_the_reference():
    """Clipped grads and the norm within 1e-6 relative; the reference's
    3-4-5 case exactly as its own test has it."""
    for g, max_norm in ((_tree(3), 0.5), (_tree(4), 1e3)):
        got, norm = OPT.clip_by_global_norm(_torch(g), max_norm)
        want, rnorm = REF_OPT.clip_by_global_norm(_jnp(g), max_norm)
        _assert_trees(got, want, 1e-6, "clipped")
        assert _rel(norm, rnorm) <= 1e-6
    got, norm = OPT.clip_by_global_norm({"w": torch.tensor([3.0, 4.0])}, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6
    np.testing.assert_allclose(got["w"].numpy(), [0.6, 0.8], rtol=1e-6)


def test_compress_int8_equals_the_reference():
    """Two rounds with error feedback: the dequantized grads within 1e-6
    relative, the error feedback exactly (the same float32 ops)."""
    grads = _tree(5)
    ef, ref_ef = COMP.ef_init(_torch(grads)), REF_COMP.ef_init(_jnp(grads))
    for r in range(2):
        g = _tree(20 + r)
        out, ef = COMP.compress_int8(_torch(g), ef)
        rout, ref_ef = REF_COMP.compress_int8(_jnp(g), ref_ef)
        _assert_trees(out, rout, 1e-6, "int8 grads")
        _assert_trees(ef, ref_ef, 0.0, "int8 error feedback")


def test_compress_topk_keeps_every_tie_at_the_threshold():
    """The reference's rule: the threshold is the k-th largest |g| and
    every |g| >= it is kept, so tied entries are all kept. Kept masks
    and error feedback exactly equal to the reference's."""
    g = {"t": np.array([0.5, -2.0, 2.0, 1.0, -2.0, 0.1, 0.0, 3.0, -0.3, 2.0],
                       np.float32),
         "u": _tree(6)["a"]}
    zeros = tree_map(np.zeros_like, g)
    out, ef = COMP.compress_topk(_torch(g), _torch(zeros), ratio=0.3)
    rout, ref_ef = REF_COMP.compress_topk(_jnp(g), _jnp(zeros), ratio=0.3)
    # k = 3 of 10: threshold 2.0, and all four |g| = 2 ties are kept
    assert (out["t"] != 0).sum() == 5
    for path in ("t", "u"):
        assert np.array_equal(out[path].numpy() != 0,
                              np.asarray(rout[path]) != 0)
    _assert_trees(out, rout, 0.0, "top-k grads")
    _assert_trees(ef, ref_ef, 0.0, "top-k error feedback")
    assert COMP.wire_bytes_ratio("int8") == REF_COMP.wire_bytes_ratio("int8")
    assert COMP.wire_bytes_ratio("topk", 0.1) == REF_COMP.wire_bytes_ratio(
        "topk", 0.1)
    assert COMP.wire_bytes_ratio("none") == 1.0


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_synthetic_lm_is_bit_equal():
    ours = iter(DATA.SyntheticLM(300, 17, 3, seed=4))
    ref = iter(REF_DATA.SyntheticLM(300, 17, 3, seed=4))
    for _ in range(3):
        a, b = next(ours), next(ref)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_markov_stream_is_bit_equal():
    ours = DATA.markov_stream(50, 12, 4, seed=3, temperature=0.5)
    ref = REF_DATA.markov_stream(50, 12, 4, seed=3, temperature=0.5)
    for _ in range(3):
        a, b = next(ours), next(ref)
        for k in ("tokens", "labels"):
            assert np.array_equal(a[k], b[k])


def test_to_device_keeps_integer_tokens():
    batch = next(iter(DATA.SyntheticLM(10, 4, 2)))
    out = DATA.to_device(batch, "cpu")
    assert out["tokens"].dtype == torch.int32
    assert np.array_equal(out["labels"].numpy(), batch["labels"])
    out = DATA.to_device({"tokens": torch.zeros(2, 3, dtype=torch.int64)},
                         "cpu")
    assert out["tokens"].dtype == torch.int64


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------

def _pair(arch, dtype):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke, dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=dtype)
    ref = ref_get_model(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    params = from_reference_params(cfg, jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref, ref_params, get_model(cfg), params


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab[0, -3:] = -1                      # ignored positions
    return {"tokens": tok, "labels": lab}


def _port_value_and_grad(model, params, batch, remat="none"):
    (loss, metrics), grads = TL._value_and_grad(
        model, remat, params, {k: torch.as_tensor(v) for k, v in
                               batch.items()})
    return loss, metrics, grads


@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_grads_equal_the_reference_f32(arch):
    """float32: the loss, its metrics (the MoE's lb_loss included) and
    every gradient leaf within 1e-5 relative (of the leaf's max |g|)."""
    ref, ref_params, model, params = _pair(arch, "float32")
    batch = _batch(model.cfg, 2, 40, seed=1)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.loss(p, b), has_aux=True))(
        ref_params, jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = _port_value_and_grad(model, params, batch)
    assert _rel(loss, rloss) <= 1e-5
    for k in ("ce_loss", "lb_loss"):
        assert abs(float(metrics[k]) - float(rmet[k])) <= 1e-5 * max(
            abs(float(rmet[k])), 1.0), k
    if model.cfg.family == "moe":
        assert float(metrics["lb_loss"]) > 0.5
    _assert_trees(grads, rgrads, 1e-5, f"{arch} grads")


@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_grads_equal_the_reference_bf16(arch):
    """bfloat16 activations (float32 masters): against the reference run
    op by op (``jax.disable_jit``), whose roundings the port follows; the
    loss within 2e-2 relative and every gradient leaf within 2e-2 of the
    leaf's max |g|."""
    ref, ref_params, model, params = _pair(arch, "bfloat16")
    batch = _batch(model.cfg, 2, 24, seed=2)
    with jax.disable_jit():
        (rloss, _), rgrads = jax.value_and_grad(
            lambda p, b: ref.loss(p, b), has_aux=True)(
            ref_params, jax.tree.map(jnp.asarray, batch))
    loss, _, grads = _port_value_and_grad(model, params, batch)
    assert _rel(loss, rloss) <= 2e-2
    _assert_trees(grads, rgrads, 2e-2, f"{arch} bf16 grads")


def test_chunked_ce_loss_with_a_ragged_last_block():
    """S = 20 in blocks of 8 (the last padded with label -1), some labels
    ignored: the loss and the gradients w.r.t. the hidden states and the
    embedding within 1e-6 relative (float32)."""
    ref, ref_params, model, params = _pair("smollm-135m", "float32")
    cfg = model.cfg
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    labels[1, 4:9] = -1

    def ref_loss(x, embed):
        return REF_T.chunked_ce_loss(ref.cfg, {**ref_params, "embed": embed},
                                     x, jnp.asarray(labels), block=8)
    rl, (rgx, rge) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(x), ref_params["embed"])
    xt = torch.tensor(x, requires_grad=True)
    embed = params["embed"].clone().requires_grad_()
    loss = T.chunked_ce_loss(cfg, {**params, "embed": embed}, xt,
                             torch.as_tensor(labels), block=8)
    gx, ge = torch.autograd.grad(loss, (xt, embed))
    assert _rel(loss, rl) <= 1e-6
    assert _rel(gx, rgx) <= 1e-6 and _rel(ge, rge) <= 1e-6


@pytest.mark.parametrize("arch", TRAINED)
def test_remat_policies_give_the_same_loss_and_grads(arch):
    """"none", "full" (recompute each layer) and "dots" (save the plain
    matmuls, recompute the rest): the same loss and gradients, bit for
    bit (recomputation repeats the same CPU ops)."""
    _, _, model, params = _pair(arch, "float32")
    batch = _batch(model.cfg, 2, 16, seed=3)
    base = _port_value_and_grad(model, params, batch)
    for remat in ("full", "dots"):
        loss, _, grads = _port_value_and_grad(model, params, batch, remat)
        assert torch.equal(loss, base[0]), remat
        for (p, g), (_, h) in zip(flatten(grads), flatten(base[2])):
            assert torch.equal(g, h), (remat, p)
    with pytest.raises(ValueError, match="remat"):
        T.maybe_remat(lambda x: x, "sometimes")


# ---------------------------------------------------------------------------
# Attention with a recomputing backward
# ---------------------------------------------------------------------------

# B, S, Hq, Hkv, Dh, causal, window, q_block, kv_block: block multiples,
# a padded last block, a window that bites, non-causal, G = 3
FLASH_CASES = [(2, 64, 4, 2, 16, True, 0, 16, 32),
               (2, 50, 4, 2, 16, True, 0, 16, 32),
               (1, 64, 4, 1, 8, True, 10, 16, 16),
               (2, 40, 6, 2, 8, False, 0, 16, 16),
               (1, 33, 9, 3, 8, True, 7, 8, 16)]


def _qkvd(case, seed):
    B, S, Hq, Hkv, Dh = case[:5]
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=sh).astype(np.float32) for sh in (
        (B, S, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh), (B, S, Hq, Dh)))


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_attention_flash_grads_equal_the_reference_vjp(case):
    """The port's `attention_flash` at the case's blocks and
    `FlashAttentionFn` (CPU forward: `_flash_fwd_inner`; both at the
    reference's 512/1024 blocks) against the reference's custom VJP: the
    output and dq, dk, dv within 1e-5 relative (float32)."""
    causal, window, qb, kb = case[5:]
    q, k, v, do = _qkvd(case, seed=sum(case[:5]))
    out, vjp = jax.vjp(lambda q, k, v: REF_K.attention_flash(
        q, k, v, causal=causal, window=window, q_block=qb, kv_block=kb),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for fn in (lambda q, k, v: K.attention_flash(
                   q, k, v, causal=causal, window=window, q_block=qb,
                   kv_block=kb),
               lambda q, k, v: FlashAttentionFn.apply(
                   q, k, v, causal, window, None)):
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        o = fn(tq, tk, tv)
        got = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do))
        assert _rel(o, out) <= 1e-5
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("case", FLASH_CASES[1:3], ids=str)
def test_flash_lse_equals_the_references_forward(case):
    """The log-sum-exp `flash_attention(..., return_lse=True)` returns on
    the CPU (its plain version) against the reference's
    `_flash_fwd_inner` on padded inputs: within 1e-6 absolute; head h
    of (B, Hq, Sq) is the reference's (hkv, g) with h = hkv·G + g."""
    B, S, Hq, Hkv, Dh, causal, window, qb, kb = case
    q, k, v, _ = _qkvd(case, seed=1)
    out, lse = flash_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), causal=causal, window=window,
                               return_lse=True)
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    qb_, kb_ = min(512, S), min(1024, S)
    pad = lambda a, n: jnp.pad(jnp.asarray(a), ((0, 0), (0, n - S),  # noqa: E731
                                                (0, 0), (0, 0)))
    sq_p, skv_p = -(-S // qb_) * qb_, -(-S // kb_) * kb_
    rout, rlse = REF_K._flash_fwd_inner(pad(q, sq_p), pad(k, skv_p),
                                        pad(v, skv_p), causal, window,
                                        Dh ** -0.5, qb_, kb_, S)
    want = np.asarray(rlse).reshape(B, Hq, sq_p)[:, :, :S]
    assert float(np.abs(lse.numpy() - want).max()) <= 1e-6
    assert _rel(out, np.asarray(rout)[:, :S]) <= 1e-5


def test_attention_chunked_equals_the_reference():
    """An offset and a partly filled cache: within 1e-6 (float32)."""
    q, k, v, _ = _qkvd((1, 40, 4, 2, 8), seed=9)
    for causal, window, off, kv_len in ((True, 0, 0, 33), (True, 6, 0, None),
                                        (False, 0, 0, 20)):
        got = K.attention_chunked(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), causal=causal,
                                  window=window, q_offset=off, kv_len=kv_len,
                                  q_block=16, kv_block=16)
        want = REF_K.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       window=window, q_offset=off,
                                       kv_len=kv_len, q_block=16, kv_block=16)
        assert _rel(got, want) <= 1e-6


def test_mha_on_the_cpu_follows_the_references_rule(monkeypatch):
    """Above Sq·Skv = 1024² a self-attention goes to `attention_flash`
    and any other to `attention_chunked`, at or below it to
    `attention_ref`; "ref" always to `attention_ref`."""
    calls = []
    for name in ("attention_flash", "attention_chunked", "attention_ref"):
        real = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _n=name, _r=real, **kw: (
            calls.append(_n), _r(*a, **kw))[1])
    small = torch.zeros(1, 64, 2, 8)
    big = torch.zeros(1, 1100, 1, 8)
    ops.mha(small, small, small)
    ops.mha(big, big, big)
    ops.mha(big, big, big, q_offset=0, kv_len=1000)
    ops.mha(big, big, big, impl="ref")
    assert calls == ["attention_ref", "attention_flash", "attention_chunked",
                     "attention_ref"]


# ---------------------------------------------------------------------------
# Train steps and the training loop
# ---------------------------------------------------------------------------

def _ref_state_np(ref_state):
    return jax.tree.map(np.asarray, ref_state)


TIE_WINDOW = 2e-4


def _int8_tie_sites(monkeypatch):
    """Record, per parameter path, the entries whose int8 quantization
    input gf/scale lies within TIE_WINDOW of a rounding tie (a
    half-integer) in any step, by observing the port's `compress_int8`
    calls. gf/scale is at most 127 in magnitude, so a gradient that
    differs in its last float32 bits (~1e-6 of the leaf's max) moves it
    by up to ~1.3e-4."""
    ties = {}
    real = COMP.compress_int8

    def observed(grads, ef):
        e = dict(flatten(ef))
        for path, g in flatten(grads):
            gf = g.float() + e[path]
            x = gf / (torch.clamp(gf.abs().max(), min=1e-12) / 127.0)
            near = (x - torch.floor(x) - 0.5).abs() < TIE_WINDOW
            ties[path] = ties.get(path, torch.zeros_like(near)) | near
        return real(grads, ef)
    monkeypatch.setattr(COMP, "compress_int8", observed)
    return ties


def _compare_state(state, ref_state, keys, ties, what):
    """Every entry of state[keys] within 1e-5 (allclose) of the
    reference's, except the entries recorded in `ties`."""
    want = dict(flatten(_ref_state_np(ref_state)))
    for path, got in flatten({k: state[k] for k in keys}):
        leaf = path.split("/", 2)[-1] if path.startswith("opt/") else (
            path.split("/", 1)[1])
        a, b = got.numpy(), want[path].astype(np.float32)
        close = np.abs(a - b) <= 1e-5 + 1e-5 * np.abs(b)
        if leaf in ties:
            close |= ties[leaf].numpy()
        assert close.all(), (what, path, int((~close).sum()))


@pytest.mark.parametrize("compression", ["none", "int8", "topk"])
def test_train_steps_equal_the_reference(compression, monkeypatch):
    """Three train steps of `make_train_step` from one reference state
    (carried over by `from_reference_state`), 2 microbatches of 2: the
    params, m, v and (with compression) the error feedback within 1e-5
    (absolute and relative, as allclose: Adam divides each entry by its
    own gradient scale, so a float32 rounding of a small gradient moves
    its update by up to lr times its relative error), the losses within
    1e-5 relative and the step counter equal.

    int8 rounds half to even, so an entry whose quantization input lies
    within rounding of a half-integer can round to the neighbouring
    level on one side: the two packages' gradients differ in their last
    bits (other summation orders), and with ~10^5 entries a few dozen
    such ties occur each step. Where one does, that entry's update
    differs by a whole Adam step, which moves every later gradient by
    more than rounding; so with int8 each step starts the port from the
    reference's state of that step (one step at a time, three times),
    and the entries within TIE_WINDOW of a tie (recorded from the port's
    own quantization inputs; 2 x TIE_WINDOW of the entries a step where
    positions are uniform) are exempt, their count at most twice that.
    Every other entry is held to the bar. Without int8 the port runs
    the three steps on its own state and nothing is exempt."""
    arch = "smollm-135m"
    ties = _int8_tie_sites(monkeypatch) if compression == "int8" else {}
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke, dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
    opt_kw = dict(lr=1e-2, warmup_steps=1, total_steps=10,
                  compression=compression, topk_ratio=0.25)
    tkw = dict(seq_len=12, global_batch=4, microbatch=2)
    ref_model = ref_get_model(ref_cfg)
    ref_state = REF_TL.init_state(ref_model, RefOptCfg(**opt_kw),
                                  jax.random.PRNGKey(0))
    state = from_reference_state(cfg, _ref_state_np(ref_state), "cpu")
    ref_step = jax.jit(REF_TL.make_train_step(
        ref_model, RefTrainCfg(**tkw, optimizer=RefOptCfg(**opt_kw))))
    step = TL.make_train_step(get_model(cfg), TrainConfig(
        **tkw, optimizer=OptimizerConfig(**opt_kw)))
    data = DATA.SyntheticLM(cfg.vocab_size, 12, 4, seed=5)
    keys = ("params", "opt") + (("ef",) if compression != "none" else ())
    for i, batch in zip(range(3), data):
        if compression == "int8":
            state = from_reference_state(cfg, _ref_state_np(ref_state), "cpu")
            ties.clear()
        ref_state, rmet = ref_step(ref_state, jax.tree.map(jnp.asarray, batch))
        state, met = step(state, DATA.to_device(batch, "cpu"))
        assert abs(float(met["loss"]) - float(rmet["loss"])) <= 1e-5 * abs(
            float(rmet["loss"]))
        assert int(state["step"]) == int(ref_state["step"]) == i + 1
        n_ties = sum(int(t.sum()) for t in ties.values())
        n_entries = sum(t.numel() for _, t in flatten(state["params"]))
        assert n_ties <= 2 * 2 * TIE_WINDOW * n_entries, n_ties
        if compression == "int8" or i == 2:
            _compare_state(state, ref_state, keys, ties,
                           f"{compression}, step {i}")


def test_microbatches_average_the_full_batch_gradient():
    """The reference's equivalence test: with and without 2 microbatches
    of 4 one step gives params within 1e-5 relative of each other."""
    cfg = dataclasses.replace(get_arch("smollm-135m").smoke, dtype="float32")
    model = get_model(cfg)
    state = TL.init_state(model, OptimizerConfig(), 0, "cpu")
    batch = DATA.to_device(next(iter(DATA.SyntheticLM(cfg.vocab_size, 16, 8))),
                           "cpu")
    outs = [TL.make_train_step(model, TrainConfig(
        seq_len=16, global_batch=8, microbatch=mb))(
            tree_map(torch.clone, state), batch)[0] for mb in (0, 4)]
    for (p, a), (_, b) in zip(flatten(outs[0]["params"]),
                              flatten(outs[1]["params"])):
        assert _rel(a, b.numpy()) <= 1e-5, p


def test_run_records_step_time_and_the_loss_falls():
    """`run` on learnable data: step_time_s and tokens recorded each
    step, and the loss falls, as the reference's test checks."""
    cfg = get_arch("smollm-135m").smoke
    tcfg = TrainConfig(seq_len=32, global_batch=8, steps=30, log_every=0,
                       optimizer=OptimizerConfig(lr=1e-2, warmup_steps=3,
                                                 total_steps=30))
    data = DATA.markov_stream(cfg.vocab_size, 32, 8, seed=0)
    seen = []
    out = TL.run(get_model(cfg), tcfg, data, device="cpu",
                 step_callback=lambda i, s, m: seen.append(i))
    hist = out["history"]
    assert seen == list(range(30)) and int(out["state"]["step"]) == 30
    assert all(h["step_time_s"] > 0 and h["tokens"] == 256 for h in hist)
    assert np.mean([h["loss"] for h in hist[-5:]]) < hist[0]["loss"] - 0.3


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _mixed_state(seed):
    """A state with float32, bfloat16 and int32 leaves (numpy side)."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                       "h": rng.normal(size=(4,)).astype(jnp.bfloat16)},
            "step": np.asarray(7, np.int32)}


def test_reference_checkpoint_loads_bit_equal_into_the_port(tmp_path):
    """A checkpoint the reference writes (bfloat16 as uint16 bits) reads
    into the port bit for bit, and the two manifests agree."""
    state = _mixed_state(0)
    info = REF_CKPT.save(str(tmp_path / "ref"), jax.tree.map(jnp.asarray,
                                                             state), step=7)
    abstract = {"params": {"w": torch.empty(5, 3, device="meta"),
                           "h": torch.empty(4, dtype=torch.bfloat16,
                                            device="meta")},
                "step": torch.empty((), dtype=torch.int32, device="meta")}
    got = CKPT.load(str(tmp_path / "ref"), abstract, device="cpu")
    assert got["params"]["h"].dtype == torch.bfloat16
    assert np.array_equal(got["params"]["h"].view(torch.int16).numpy()
                          .view(np.uint16), state["params"]["h"].view(np.uint16))
    assert np.array_equal(got["params"]["w"].numpy(), state["params"]["w"])
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32
    ours = CKPT.save(str(tmp_path / "port"), tree_map(
        lambda a: torch.from_numpy(np.asarray(a).astype(np.float32)).to(
            torch.bfloat16) if a.dtype == jnp.bfloat16 else torch.from_numpy(
            np.asarray(a)), state), step=7)
    assert ours["bytes"] == info["bytes"]
    assert CKPT.manifest(str(tmp_path / "port")) == REF_CKPT.manifest(
        str(tmp_path / "ref"))
    with pytest.raises(KeyError, match="missing"):
        CKPT.load(str(tmp_path / "ref"), {"nope": abstract["step"]}, "cpu")
    with pytest.raises(ValueError, match="shape"):
        CKPT.load(str(tmp_path / "ref"), {"step": torch.empty(2, device="meta")},
                  "cpu")


def test_port_checkpoint_loads_bit_equal_into_the_reference(tmp_path):
    """A smoke train state the port writes (one leaf in bfloat16) reads
    into the reference bit for bit, leaf by leaf."""
    cfg = get_arch("smollm-135m").smoke
    model = get_model(cfg)
    state = TL.init_state(model, OptimizerConfig(compression="int8"), 3, "cpu")
    state["params"]["embed"] = state["params"]["embed"].to(torch.bfloat16)
    CKPT.save(str(tmp_path), state, step=11)
    abstract = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), {torch.float32: jnp.float32, torch.int32: jnp.int32,
                         torch.bfloat16: jnp.bfloat16}[t.dtype]), state)
    got = REF_CKPT.load(str(tmp_path), abstract)
    for (path, a), (_, b) in zip(flatten(state), flatten(jax.tree.map(
            np.asarray, got))):
        if a.dtype == torch.bfloat16:
            assert b.dtype == jnp.bfloat16
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16)), path
        else:
            assert np.array_equal(a.numpy(), b), path
    assert REF_CKPT.manifest(str(tmp_path))["step"] == 11


def test_train_state_round_trips_through_the_abstract_state(tmp_path):
    """`loop.abstract_state` restores a whole state bit for bit."""
    model = get_model(get_arch("olmoe-1b-7b").smoke)
    opt = OptimizerConfig(compression="topk")
    state = TL.init_state(model, opt, 1, "cpu")
    state["step"] = state["step"] + 5
    CKPT.save(str(tmp_path), state, step=5)
    got = CKPT.load(str(tmp_path), TL.abstract_state(model, opt), "cpu")
    for (p, a), (q, b) in zip(flatten(state), flatten(got)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b), p


def test_checkpoint_manager_gc_latest_and_async(tmp_path):
    """keep=2 keeps the two newest; the latest restores; an async save
    returns None and `last_info` waits for it; an error on the writer
    thread is raised in the caller."""
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    abstract = {"w": torch.empty(2, 3, device="meta")}
    mgr = CKPT.CheckpointManager(str(tmp_path / "a"), keep=2,
                                 async_save=False)
    for s in (1, 2, 3):
        info = mgr.save(s, {"w": state["w"] * s})
        assert info["bytes"] == 24
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    got, step = mgr.restore(abstract, device="cpu")
    assert step == 3 and torch.equal(got["w"], state["w"] * 3)
    got, _ = mgr.restore(abstract, step=2, device="cpu")
    assert torch.equal(got["w"], state["w"] * 2)
    amgr = CKPT.CheckpointManager(str(tmp_path / "b"), keep=3,
                                  async_save=True)
    assert amgr.save(4, state) is None
    assert amgr.last_info()["bytes"] == 24 and amgr.latest_step() == 4
    with pytest.raises(FileNotFoundError):
        CKPT.CheckpointManager(str(tmp_path / "c")).restore(abstract,
                                                            device="cpu")
    bad = CKPT.CheckpointManager(str(tmp_path / "d"), async_save=True)
    open(bad.step_dir(1), "w").close()      # a file where the dir goes
    bad.save(1, state)
    with pytest.raises(FileExistsError):
        bad.wait()
    assert bad.all_steps() == []
