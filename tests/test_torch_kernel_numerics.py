"""The numerics that the bf16 tensor-core kernels choose, emulated in plain
torch on the CPU and held against the JAX package's Pallas kernels in
interpret mode (as tests/test_torch_attention.py and test_torch_ssd.py
run them). Inputs are made with numpy from a seed.

- flash (wgmma route): scores from bf16 operands in f32, scaled after the
  dot, an online softmax over 64-key tiles in f32, and P rounded to bf16
  per tile for the P.V product; bar 2e-2.
- SSD (mma.sync route): B, C and x exact bf16 operands; the f32
  intermediates (x w of the chunk state, the decayed score matrix, the
  entering state) split into bf16 hi + lo, two products each; bars 1e-1
  (y) and 5e-3 (h_final).

Each test records its margin: the largest error over the bar, where the
bar is abs + rel * |reference| as in numpy's allclose.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.ssd_scan import ssd_pallas  # noqa: E402

from repro_torch.kernels.ref import NEG_INF  # noqa: E402

BK = 64          # keys per tile of the wgmma kernel


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split(x: torch.Tensor):
    """f32 -> (hi, lo) bf16 values, x = hi + lo + O(2^-16 |x|)."""
    hi = _bf16_round(x)
    return hi, _bf16_round(x - hi)


def _margin(got, want, atol, rtol):
    """max |got - want| / (atol + rtol |want|): below 1 passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def flash_wgmma_emulation(q, k, v, *, causal=True, window=0):
    """The wgmma kernel's arithmetic on the CPU: q (B,Sq,Hq,Dh), k, v
    (B,Skv,Hkv,Dh) bf16 -> bf16."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = Dh ** -0.5
    qf = q.float().permute(0, 2, 1, 3)                       # (B,Hq,Sq,Dh)
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    m = torch.full((B, Hq, Sq, 1), NEG_INF)
    l = torch.zeros(B, Hq, Sq, 1)
    acc = torch.zeros(B, Hq, Sq, Dh)
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, BK):
        kpos = torch.arange(k0, min(k0 + BK, Skv))[None, :]
        s = (qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2)) * scale
        ok = kpos < Skv
        if causal:
            ok = ok & (kpos <= qpos)
        if window > 0:
            ok = ok & (kpos > qpos - window)
        s = s + torch.where(ok, 0.0, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _bf16_round(p) @ vf[:, :, k0:k0 + BK]
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


# B, S, Hq, Hkv, Dh, causal, window: the wgmma route's head widths, GQA,
# a ragged tail and windows that end inside a tile
FLASH_CASES = [(2, 128, 4, 2, 64, True, 0), (1, 200, 6, 2, 128, True, 70),
               (1, 96, 4, 1, 256, False, 0), (2, 160, 3, 3, 64, False, 40)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_wgmma_numerics_match_pallas_interpret(case, record_property):
    B, S, Hq, Hkv, Dh, causal, window = case
    rng = np.random.default_rng(sum(case[:5]))
    arrs = [rng.normal(size=(B, S, h, Dh)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    want = jflash(jq, jk, jv, causal=causal, window=window, block_q=64,
                  block_kv=64, interpret=True)
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in arrs)
    got = flash_wgmma_emulation(q, k, v, causal=causal, window=window)
    want = np.asarray(want, np.float32)
    margin = _margin(got.float().numpy(), want, 2e-2, 2e-2)
    record_property("margin", margin)
    assert margin < 1.0, f"error is {margin:.3f} of the 2e-2 bar"


def ssd_mma_emulation(x, dt, a_log, b, c, d, *, chunk):
    """The mma.sync kernel's arithmetic on the CPU (G = 1, zero initial
    state): x (B,S,H,P), b, c (B,S,1,N) bf16; dt (B,S,H), a_log, d (H,)
    f32. Returns (y bf16, h_final f32)."""
    B, S, H, P = x.shape
    N = b.shape[3]
    Q = min(chunk, S)
    nc = S // Q
    xf = x.float().reshape(B, nc, Q, H, P)
    bf = b.float().reshape(B, nc, Q, N)
    cf = c.float().reshape(B, nc, Q, N)
    dtf = dt.float().reshape(B, nc, Q, H)
    cum = torch.cumsum(dtf * -torch.exp(a_log.float()), dim=2)   # (B,nc,Q,H)
    # launch 1: S_c = (x w)^T B with x w as hi + lo
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtf
    xw_hi, xw_lo = _split(xf * w[..., None])
    own = (torch.einsum("bcqhp,bcqn->bchpn", xw_hi, bf)
           + torch.einsum("bcqhp,bcqn->bchpn", xw_lo, bf))
    # launch 2: the carry in f32
    h = torch.zeros(B, H, P, N)
    h_in = []
    for ci in range(nc):
        h_in.append(h)
        h = h * torch.exp(cum[:, ci, -1, :])[..., None, None] + own[:, ci]
    h_in = torch.stack(h_in, 1)                                   # (B,nc,H,P,N)
    # launch 3: M = (C B^T) exp(cum_q - cum_k) dt_k (k <= q) as hi + lo
    scores = torch.einsum("bcqn,bckn->bcqk", cf, bf)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # (B,nc,q,k,H)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, None, :, :, None]
    decay = torch.exp(torch.where(tri, seg, torch.zeros(())))
    mm = torch.where(tri, scores[..., None] * decay * dtf[:, :, None, :, :],
                     torch.zeros(()))
    m_hi, m_lo = _split(mm)
    y_diag = (torch.einsum("bcqkh,bckhp->bcqhp", m_hi, xf)
              + torch.einsum("bcqkh,bckhp->bcqhp", m_lo, xf))
    h_hi, h_lo = _split(h_in)
    y_off = (torch.einsum("bcqn,bchpn->bcqhp", cf, h_hi)
             + torch.einsum("bcqn,bchpn->bcqhp", cf, h_lo))
    y = (y_diag + torch.exp(cum)[..., None] * y_off
         + xf * d.float()[None, None, None, :, None])
    return y.reshape(B, S, H, P).to(torch.bfloat16), h


# B, S, H, P, N, chunk, Pallas head block: tests/test_kernels.py's
# SSD_CASES and a chunk of 64 with N 128
SSD_CASES = [(2, 64, 4, 16, 32, 16, 2), (1, 128, 8, 32, 64, 32, 4),
             (2, 96, 4, 64, 16, 32, 4), (1, 128, 4, 64, 128, 64, 4)]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_mma_numerics_match_pallas_interpret(case, record_property):
    B, S, H, P, N, Q, bh = case
    rng = np.random.default_rng(sum(case))
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    arrs = dict(x=f(B, S, H, P), dt=np.log1p(np.exp(f(B, S, H))).astype(
        np.float32), a_log=rng.uniform(0.0, 1.5, H).astype(np.float32),
        b=f(B, S, 1, N), c=f(B, S, 1, N), d=np.ones(H, np.float32))
    cast = ("x", "b", "c")
    j = {k: jnp.asarray(v, jnp.bfloat16 if k in cast else jnp.float32)
         for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).to(torch.bfloat16 if k in cast
                                   else torch.float32)
         for k, v in arrs.items()}
    jy, jh = ssd_pallas(j["x"], j["dt"], j["a_log"], j["b"], j["c"], j["d"],
                        chunk=Q, block_heads=bh, interpret=True)
    ty, th = ssd_mma_emulation(t["x"], t["dt"], t["a_log"], t["b"], t["c"],
                               t["d"], chunk=Q)
    y_margin = _margin(ty.float().numpy(), np.asarray(jy, np.float32), 1e-1,
                       1e-1)
    h_margin = _margin(th.numpy(), np.asarray(jh, np.float32), 5e-3, 5e-3)
    record_property("y_margin", y_margin)
    record_property("h_margin", h_margin)
    assert y_margin < 1.0, f"y error is {y_margin:.3f} of the 1e-1 bar"
    assert h_margin < 1.0, f"h_final error is {h_margin:.3f} of the 5e-3 bar"


def test_hi_lo_split_keeps_sixteen_bits():
    """The SSD kernel's premise: hi + lo carries an f32 value to within
    2^-16 of its magnitude (one bf16 alone: 2^-9)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=100_000).astype(np.float32)) * 1e3
    hi, lo = _split(x)
    rel = ((hi + lo - x).abs() / x.abs()).max().item()
    assert rel <= 2.0 ** -16
    assert ((hi - x).abs() / x.abs()).max().item() > 2.0 ** -10
