"""The port's attention against the JAX reference on the CPU: the flash
kernel's wrapper (on CPU tensors, its plain version) against the Pallas
kernel in interpret mode, and `attention_ref` against the reference's in
the decode case. Inputs are made with numpy from a seed and handed to
both sides."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_torch)
from repro_torch.kernels.ref import NEG_INF, attention_ref  # noqa: E402

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
