"""The port's attention against the JAX reference on the CPU: the flash
kernel's wrapper (on CPU tensors, its plain version) against the Pallas
kernel in interpret mode, and `attention_ref` against the reference's in
the decode case; the backward's kernel pairs, and its CPU route (the
plain `flash_bwd_torch`, no kernel launch or kernel cost counted). Inputs are made with numpy
from a seed and handed to both sides."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402

from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BACKWARD_KERNEL, FlashAttentionFn, backward_route, flash_attention,
    flash_attention_backward, flash_attention_torch)
from repro_torch.kernels.ref import (NEG_INF, attention_ref,  # noqa: E402
                                     flash_bwd_torch, flash_fwd_torch)

# tests/test_kernels.py's ATTN_CASES:
# B, S, Hq, Hkv, Dh, causal, window, bq, bk
ATTN_CASES = [
    (2, 128, 4, 2, 32, True, 0, 32, 32),
    (1, 64, 2, 1, 16, True, 24, 16, 32),
    (2, 128, 4, 4, 64, False, 0, 64, 64),
    (1, 96, 8, 2, 32, True, 0, 32, 48),   # uneven blocks (pad path)
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(B, Sq, Skv, Hq, Hkv, Dh, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, Hq, Dh)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, Dh)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, Dh)).astype(np.float32))


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.tensor(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_plain_matches_pallas_interpret(case, dtype):
    B, S, Hq, Hkv, Dh, causal, window, bq, bk = case
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, S, S, Hq, Hkv, Dh), jdt, tdt)
    want = jflash(jq, jk, jv, causal=causal, window=window, block_q=bq,
                  block_kv=bk, interpret=True)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before      # CPU: the plain version
    assert got.dtype == tdt and tuple(got.shape) == (B, S, Hq, Dh)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("q_offset,kv_len,sq,window", [
    (30, 31, 1, 0),        # one decode step at slot 30 of a 40-slot cache
    (0, 1, 1, 0),          # the first decode step
    (39, 40, 1, 0),        # the last slot
    (30, 37, 2, 0),        # two rows, partly filled cache
    (30, 31, 1, 8),        # decode under a sliding window
])
def test_attention_ref_decode_matches_reference(q_offset, kv_len, sq, window):
    q, k, v = _qkv(2, sq, 40, 4, 2, 16, seed=q_offset + kv_len)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window, q_offset=q_offset,
                              kv_len=kv_len)
    got = attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                        causal=True, window=window, q_offset=q_offset,
                        kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_attention_ref_ring_positions_match_reference():
    q, k, v = _qkv(1, 1, 12, 2, 1, 16, seed=3)
    pos = np.array([12, 13, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11])
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window=8, q_offset=13, kv_positions=pos)
    got = attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                        window=8, q_offset=13, kv_positions=pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_neg_inf_is_the_reference_value_and_a_masked_row_is_uniform():
    assert NEG_INF == jref.NEG_INF
    q, k, v = (torch.tensor(a) for a in _qkv(1, 1, 6, 1, 1, 16, seed=4))
    out = attention_ref(q, k, v, causal=False, kv_len=0)
    assert torch.allclose(out[0, 0, 0], v[0, :, 0].mean(0), atol=1e-6)


def test_mha_dispatch_on_the_cpu_takes_the_plain_path(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(kw))
    q, k, v = (torch.tensor(a) for a in _qkv(1, 8, 8, 2, 1, 16))
    want = attention_ref(q, k, v, window=4)
    assert torch.equal(ops.mha(q, k, v, window=4), want)     # auto, CPU
    assert torch.equal(ops.mha(q, k, v, window=4, impl="ref"), want)
    assert calls == []
    with pytest.raises(ValueError, match="unknown attention impl"):
        ops.mha(q, k, v, impl="pallas")


@pytest.mark.parametrize("bad,match", [
    ("float16", "float32 or bfloat16"),
    ("gqa", "not a multiple"),
    ("shape", "do not agree"),
    ("strided", "contiguous"),
])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    q, k, v = (torch.tensor(a) for a in _qkv(1, 8, 8, 4, 2, 16))
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "gqa":
        q = torch.zeros(1, 8, 3, 16)
    elif bad == "shape":
        v = v[:, :4].contiguous()
    else:
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v)


def test_plain_version_is_attention_ref():
    q, k, v = (torch.tensor(a) for a in _qkv(2, 16, 16, 4, 2, 32))
    assert torch.equal(flash_attention_torch(q, k, v, window=5),
                       attention_ref(q, k, v, window=5))


def test_backward_route_table():
    """The backward kernel serves bf16 at Dh 64 and 128; float32 at every
    Dh, bf16 at Dh 16, 32 and 256 and any other pair keep the plain
    float32 backward."""
    assert BACKWARD_KERNEL == {(torch.bfloat16, 64), (torch.bfloat16, 128)}
    for dh in (64, 128):
        assert backward_route(torch.bfloat16, dh) == "wgmma"
    for dh in (16, 32, 64, 128, 256):
        assert backward_route(torch.float32, dh) == "plain"
    for dh in (16, 32, 256):
        assert backward_route(torch.bfloat16, dh) == "plain"
    assert backward_route(torch.float16, 64) == "plain"
    assert backward_route(torch.bfloat16, 96) == "plain"


# B, Sq, Skv, Hq, Hkv, Dh, causal, window, dtype: a pair the card sends to
# the kernel (bf16, Dh 128, with a window) and one it keeps plain
BWD_CPU_CASES = [(1, 33, 33, 4, 1, 128, True, 9, "bfloat16"),
                 (1, 12, 30, 2, 2, 64, False, 0, "float32")]


@pytest.mark.parametrize("case", BWD_CPU_CASES, ids=str)
def test_backward_on_the_cpu_is_the_plain_version(case):
    """A CPU tensor takes `flash_bwd_torch` whatever its route on the
    card, bit for bit, directly and through `FlashAttentionFn`; the
    backward kernel's launch counter does not move, and a cost probe
    counts no call of it."""
    B, Sq, Skv, Hq, Hkv, Dh, causal, window, dtype = case
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(a).to(dt)
               for a in _qkv(B, Sq, Skv, Hq, Hkv, Dh, seed=sum(case[:6])))
    dout = torch.tensor(np.random.default_rng(1).normal(
        size=(B, Sq, Hq, Dh)).astype(np.float32)).to(dt)
    out, lse = flash_fwd_torch(q, k, v, causal, window)
    before = flash_attention_backward.launches
    calls = cost.COUNTER.calls["flash_attention_bwd"]
    with cost.COUNTER.on():
        got = flash_attention_backward(q, k, v, out, lse, dout,
                                       causal=causal, window=window)
    assert cost.COUNTER.calls["flash_attention_bwd"] == calls
    want = flash_bwd_torch(q, k, v, out, lse, dout, causal, window,
                           Dh ** -0.5, 512, 1024)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    through_fn = torch.autograd.grad(
        FlashAttentionFn.apply(*leaves, causal, window, None), leaves, dout)
    assert flash_attention_backward.launches == before
    for g, f, w in zip(got, through_fn, want):
        assert g.dtype == dt and torch.equal(g, w) and torch.equal(f, w)


def test_backward_bound_counts_the_four_products():
    """The backward's bound counts the dV, dP, dQ and dK products: 8 of
    `cost.attention_backward`'s 10 FLOPs a kept pair per Dh."""
    flops, _ = cost.attention_backward(2, 40, 40, 6, 2, 64, 2, True, 9)
    pairs = cost.attention_pairs(40, 40, True, 9)
    assert cost.ATTENTION_BACKWARD_BOUND_SHARE * flops == 8 * 2 * 6 * 64 * pairs
