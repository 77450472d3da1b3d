"""Training of the encoder-decoder family (Whisper) against the JAX
reference, on the CPU: the whisper-base smoke loss and its gradients
under each remat policy, one AdamW train step with the frames split into
microbatches like the tokens, the cross-attention's recomputing backward
with padded keys, and checkpoints of its train state read both ways. The
reference's parameters (`Model.init(PRNGKey(0))`) and train states are
carried across by `convert`; frames (seeded normal, as the reference's
`tests/test_archs_smoke.py` makes them), tokens and labels are made with
numpy from a seed. Tolerances are stated in each test."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.config import OptimizerConfig as RefOptCfg  # noqa: E402
from repro.config import TrainConfig as RefTrainCfg  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.kernels import ref as REF_K  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.train import checkpoint as REF_CKPT  # noqa: E402
from repro.train import loop as REF_TL  # noqa: E402

from repro_torch.config import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import (from_reference_params,  # noqa: E402
                                 from_reference_state)
from repro_torch.data import pipeline as DATA  # noqa: E402
from repro_torch.kernels import ref as K  # noqa: E402
from repro_torch.kernels.flash_attention import FlashAttentionFn  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten, tree_map  # noqa: E402
from repro_torch.train import checkpoint as CKPT  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402

ARCH = "whisper-base"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    """max |got - want| / max(max |want|, 1e-30)."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _configs(dtype="float32"):
    return (dataclasses.replace(ref_get_arch(ARCH).smoke, dtype=dtype),
            dataclasses.replace(get_arch(ARCH).smoke, dtype=dtype))


def _batch(cfg, B, S, seed):
    """Tokens, labels (a few ignored) and float32 frames (B, enc_seq, D)."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab[0, -3:] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": lab,
            "frames": rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(
                np.float32)}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_equal_the_reference_f32(remat):
    """float32, both sides under the same remat policy (encoder and
    decoder layers): the loss and its ce_loss within 1e-5 relative,
    every gradient leaf (the encoder's, the cross-attention's and the
    tied embedding's among them) within 1e-5 of the leaf's max |g|."""
    ref_cfg, cfg = _configs()
    ref = ref_get_model(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    params = from_reference_params(cfg, jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    batch = _batch(cfg, 2, 24, seed=1)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.loss(p, b, remat=remat), has_aux=True))(
        ref_params, jax.tree.map(jnp.asarray, batch))
    (loss, metrics), grads = TL._value_and_grad(
        get_model(cfg), remat, params,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert set(metrics) == set(rmet) == {"ce_loss"}
    assert _rel(loss, rloss) <= 1e-5
    assert _rel(metrics["ce_loss"], rmet["ce_loss"]) <= 1e-5
    want = dict(flatten(jax.tree.map(np.asarray, rgrads)))
    got = dict(flatten(grads))
    assert set(got) == set(want)
    bad = {p: _rel(got[p], want[p]) for p in want
           if _rel(got[p], want[p]) > 1e-5}
    assert not bad, bad
    assert any(p.startswith("enc_layers/") for p in got)


def test_train_step_equals_the_reference():
    """One AdamW step of `make_train_step` with 2 microbatches of 2 (the
    frames split like the tokens) from the reference's state: params, m
    and v within 1e-5 (allclose), the loss within 1e-5 relative."""
    ref_cfg, cfg = _configs()
    opt_kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    tkw = dict(seq_len=16, global_batch=4, microbatch=2)
    ref_model = ref_get_model(ref_cfg)
    ref_state = REF_TL.init_state(ref_model, RefOptCfg(**opt_kw),
                                  jax.random.PRNGKey(0))
    state = from_reference_state(cfg, jax.tree.map(np.asarray, ref_state),
                                 "cpu")
    batch = _batch(cfg, 4, 16, seed=2)
    ref_state, rmet = jax.jit(REF_TL.make_train_step(
        ref_model, RefTrainCfg(**tkw, optimizer=RefOptCfg(**opt_kw))))(
        ref_state, jax.tree.map(jnp.asarray, batch))
    state, met = TL.make_train_step(get_model(cfg), TrainConfig(
        **tkw, optimizer=OptimizerConfig(**opt_kw)))(
        state, DATA.to_device(batch, "cpu"))
    assert _rel(met["loss"], rmet["loss"]) <= 1e-5
    want = dict(flatten(jax.tree.map(np.asarray, ref_state)))
    for path, got in flatten({k: state[k] for k in ("params", "opt")}):
        np.testing.assert_allclose(got.numpy(), want[path], atol=1e-5,
                                   rtol=1e-5, err_msg=path)


def test_frames_microbatches_average_the_full_batch_gradient():
    """`to_device` moves the frames with the tokens, and a step with 2
    microbatches of 2 gives params within 1e-5 relative of the full
    batch's step (the reference's equivalence test, with frames)."""
    _, cfg = _configs()
    model = get_model(cfg)
    state = TL.init_state(model, OptimizerConfig(), 0, "cpu")
    batch = DATA.to_device(_batch(cfg, 4, 16, seed=3), "cpu")
    assert batch["frames"].dtype == torch.float32
    outs = [TL.make_train_step(model, TrainConfig(
        seq_len=16, global_batch=4, microbatch=mb))(
            tree_map(torch.clone, state), batch)[0] for mb in (0, 2)]
    for (p, a), (_, b) in zip(flatten(outs[0]["params"]),
                              flatten(outs[1]["params"])):
        assert _rel(a, b) <= 1e-5, p


# B, Sq, Skv, Hq, Hkv, Dh, q_block, kv_block: a cross-attention whose keys
# pad to a kv block multiple (Whisper's 448 rows against 1,500 frames, cut
# down), and one whose rows pad too
CROSS_CASES = [(2, 24, 75, 4, 4, 16, 8, 32), (1, 20, 50, 4, 2, 8, 16, 16)]


@pytest.mark.parametrize("case", CROSS_CASES, ids=str)
def test_cross_attention_backward_masks_the_padded_keys(case):
    """Non-causal attention of Sq rows against Skv != Sq keys through the
    recomputing backward (`ref.FlashAttention` at small blocks, so that
    the keys pad past Skv; and `FlashAttentionFn`, whose CPU forward is
    the same plain version at the reference's blocks): out and dq, dk,
    dv within 1e-5 of max |g| of JAX's autodiff of the reference's
    `attention_ref`."""
    B, Sq, Skv, Hq, Hkv, Dh, qb, kb = case
    rng = np.random.default_rng(sum(case))
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in (
        (B, Sq, Hq, Dh), (B, Skv, Hkv, Dh), (B, Skv, Hkv, Dh),
        (B, Sq, Hq, Dh)))
    out, vjp = jax.vjp(lambda q, k, v: REF_K.attention_ref(
        q, k, v, causal=False), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for fn in (lambda q, k, v: K.FlashAttention.apply(
                   q, k, v, False, 0, None, qb, kb),
               lambda q, k, v: FlashAttentionFn.apply(q, k, v, False, 0,
                                                      None)):
        leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        o = fn(*leaves)
        got = torch.autograd.grad(o, leaves, torch.tensor(do))
        assert _rel(o, out) <= 1e-5
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-5


def test_train_state_checkpoints_read_both_ways(tmp_path):
    """A whisper-base smoke train state the port writes reads into the
    reference bit for bit, and one the reference writes reads into the
    port's `abstract_state` bit for bit."""
    ref_cfg, cfg = _configs()
    model, ref_model = get_model(cfg), ref_get_model(ref_cfg)
    state = TL.init_state(model, OptimizerConfig(), 5, "cpu")
    CKPT.save(str(tmp_path / "port"), state, step=2)
    got = dict(flatten(jax.tree.map(np.asarray, REF_CKPT.load(
        str(tmp_path / "port"), REF_TL.abstract_state(ref_model,
                                                      RefOptCfg())))))
    ours = dict(flatten(state))
    assert set(got) == set(ours)
    for path, t in ours.items():
        assert np.array_equal(t.numpy(), got[path]), path
    ref_state = REF_TL.init_state(ref_model, RefOptCfg(),
                                  jax.random.PRNGKey(2))
    REF_CKPT.save(str(tmp_path / "ref"), ref_state, step=3)
    back = CKPT.load(str(tmp_path / "ref"),
                     TL.abstract_state(model, OptimizerConfig()), "cpu")
    want = dict(flatten(jax.tree.map(np.asarray, ref_state)))
    for path, t in flatten(back):
        assert np.array_equal(t.numpy(), want[path]), path


def test_train_launcher_names_the_missing_frames():
    """`python -m repro_torch.launch.train --arch whisper-base` stops
    before building anything, naming the frames its markov data lacks
    (the reference's launcher would fail on the missing key)."""
    from repro_torch.launch import train as train_launch
    with pytest.raises(SystemExit, match="frames"):
        train_launch.main(["--arch", "whisper-base", "--steps", "1",
                           "--device", "cpu"])
