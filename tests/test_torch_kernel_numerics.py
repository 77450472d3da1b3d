"""The numerics that the bf16 tensor-core kernels choose, emulated in plain
torch on the CPU and held against the JAX package's Pallas kernels in
interpret mode (as tests/test_torch_attention.py and test_torch_ssd.py
run them). Inputs are made with numpy from a seed.

- flash (wgmma route): scores from bf16 operands in f32, scaled after the
  dot, an online softmax over 64-key tiles in f32, and P rounded to bf16
  per tile for the P.V product; bar 2e-2.
- flash backward (the bf16 kernel of `flash_attention_backward`): blocks
  of 128 keys over the q tiles of 64 rows that their masks keep, S^T and
  dP^T from bf16 operands in f32, P and dS rounded to bf16 before the dV,
  dK and dQ products, dQ summed in f32 over the blocks (in the kernel's
  fixed order: ascending key block) and scaled last; bar 2e-2 of each
  gradient's max |g| against JAX's VJP of the reference's
  `attention_ref`. The kernel's dQ order rests on its tiling: the key
  blocks that run over a q tile are a run from the first one its counter
  waits for, and cover every kept pair.
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
from repro.kernels.ref import attention_ref as jattention_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_pallas  # noqa: E402

from repro_torch.kernels.ref import NEG_INF, flash_fwd_torch  # noqa: E402

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


BWD_BN, BWD_BM = 128, 64    # keys per block, q rows per tile of the backward


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, ...) -> (B, n, ...), zeros past S."""
    out = x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))
    out[:, :x.shape[1]] = x
    return out


def bwd_q_tiles(k0: int, Sq: int, Skv: int, causal: bool,
                window: int) -> range:
    """The q tiles the backward kernel runs its block of keys k0 .. over
    (`qt_begin`, `qt_end` of the .cu)."""
    nqt = -(-Sq // BWD_BM)
    k_last = min(k0 + BWD_BN, Skv) - 1
    qt_begin = k0 // BWD_BM if causal else 0
    qt_end = (min(nqt, (k_last + window - 1) // BWD_BM + 1) if window > 0
              else nqt)
    return range(qt_begin, qt_end)


def bwd_dq_first_key_tile(qt: int, Skv: int, window: int) -> int:
    """The key block whose dQ the kernel adds into q tile `qt` first (the
    adding thread's `lo`): the rank of block n there is n - lo."""
    lo = 0
    if window > 0:
        while (min(lo * BWD_BN + BWD_BN, Skv) - 1 + window - 1) // BWD_BM + 1 <= qt:
            lo += 1
    return lo


def flash_bwd_wgmma_emulation(q, k, v, out, lse, dout, *, causal=True,
                              window=0):
    """The backward kernel's arithmetic and tiling on the CPU: q, out,
    dout (B,Sq,Hq,Dh), k, v (B,Skv,Hkv,Dh) bf16, lse (B,Hq,Sq) f32 ->
    dq, dk, dv bf16."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = Dh ** -0.5
    sq_pad = -(-Sq // BWD_BM) * BWD_BM
    qf, dof = (_pad_rows(t.float(), sq_pad) for t in (q, dout))
    delta = _pad_rows((dout.float() * out.float()).sum(-1), sq_pad)
    lse_p = _pad_rows(lse.transpose(1, 2), sq_pad)          # (B,Sq_pad,Hq)
    nkt = -(-Skv // BWD_BN)
    kf, vf = (_pad_rows(t.float(), nkt * BWD_BN) for t in (k, v))
    dq_acc = torch.zeros(B, sq_pad, Hq, Dh)
    dk = torch.zeros(B, Skv, Hkv, Dh, dtype=torch.bfloat16)
    dv = torch.zeros_like(dk)
    for kt in range(nkt):
        k0 = kt * BWD_BN
        keys = torch.arange(k0, k0 + BWD_BN)[:, None]
        for hkv in range(Hkv):
            kb, vb = kf[:, k0:k0 + BWD_BN, hkv], vf[:, k0:k0 + BWD_BN, hkv]
            dk_acc = torch.zeros(B, BWD_BN, Dh)
            dv_acc = torch.zeros(B, BWD_BN, Dh)
            for h in range(hkv * G, (hkv + 1) * G):
                for qt in bwd_q_tiles(k0, Sq, Skv, causal, window):
                    rows = slice(qt * BWD_BM, (qt + 1) * BWD_BM)
                    qpos = torch.arange(rows.start, rows.stop)[None, :]
                    qb, dob = qf[:, rows, h], dof[:, rows, h]
                    ok = (keys < Skv) & (qpos < Sq)
                    if causal:
                        ok = ok & (keys <= qpos)
                    if window > 0:
                        ok = ok & (keys > qpos - window)
                    st = kb @ qb.transpose(1, 2)              # (B,128,64)
                    dpt = vb @ dob.transpose(1, 2)
                    p = torch.exp(st * scale + torch.where(ok, 0.0, NEG_INF)
                                  - lse_p[:, None, rows, h])
                    ds = p * (dpt - delta[:, None, rows, h])
                    dv_acc += _bf16_round(p) @ dob
                    dk_acc += _bf16_round(ds) @ qb
                    dq_acc[:, rows, h] += _bf16_round(ds).transpose(1, 2) @ kb
            n = min(BWD_BN, Skv - k0)
            dk[:, k0:k0 + n, hkv] = (dk_acc[:, :n] * scale).to(torch.bfloat16)
            dv[:, k0:k0 + n, hkv] = dv_acc[:, :n].to(torch.bfloat16)
    return (dq_acc[:, :Sq] * scale).to(torch.bfloat16), dk, dv


# B, Sq, Skv, Hq, Hkv, Dh, causal, window: the kernel's head widths, GQA,
# a ragged q and kv tail, a window that ends inside a tile, and a
# non-causal cross-attention with Sq != Skv (Whisper's)
FLASH_BWD_CASES = [(2, 200, 200, 6, 2, 64, True, 0),
                   (1, 300, 300, 4, 1, 128, True, 70),
                   (1, 40, 130, 4, 2, 64, False, 0),
                   (2, 160, 160, 3, 3, 128, False, 40)]


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
def test_flash_bwd_wgmma_numerics_match_the_reference_vjp(case,
                                                          record_property):
    B, Sq, Skv, Hq, Hkv, Dh, causal, window = case
    rng = np.random.default_rng(sum(case[:6]))
    arrs = [rng.normal(size=(B, s, h, Dh)).astype(np.float32)
            for s, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv), (Sq, Hq))]
    q, k, v, dout = (torch.tensor(a).to(torch.bfloat16) for a in arrs)
    out, lse = flash_fwd_torch(q, k, v, causal, window)
    got = flash_bwd_wgmma_emulation(q, k, v, out, lse, dout, causal=causal,
                                    window=window)
    _, vjp = jax.vjp(lambda *t: jattention_ref(*t, causal=causal,
                                               window=window),
                     *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(dout.float().numpy()))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        margin = float(np.abs(g.float().numpy() - w).max()
                       / (2e-2 * np.abs(w).max()))
        record_property(f"{name}_margin", margin)
        assert margin < 1.0, f"{name} error is {margin:.3f} of the 2e-2 bar"


# Sq, Skv, causal, window: the card tests' masks, SmolLM-135M's two
# microbatch lengths, RecurrentGemma's 2,048-key window at 4,096, windows
# that end inside a tile, and a window wider than the keys
DQ_ORDER_CASES = [(700, 700, True, 200), (4, 1500, False, 0),
                  (448, 1500, False, 0), (1000, 200, True, 0),
                  (200, 1000, True, 0), (1100, 1100, True, 0),
                  (1000, 1000, False, 300), (4096, 4096, True, 0),
                  (512, 512, True, 0), (300, 300, True, 70),
                  (4096, 4096, True, 2048), (160, 160, False, 40),
                  (130, 130, True, 5000)]


@pytest.mark.parametrize("case", DQ_ORDER_CASES, ids=str)
def test_flash_bwd_dq_adders_are_a_run_from_the_first(case):
    """For every q tile, the key blocks the backward kernel runs over it
    are lo, lo + 1, .., hi with lo the one its dQ counter lets add first,
    so that each rank 0 .. hi - lo is taken once and the adds wait only
    on blocks issued before them; and they hold every key the masks keep
    for the tile's rows, so that no pair's gradient is left out."""
    Sq, Skv, causal, window = case
    nqt, nkt = -(-Sq // BWD_BM), -(-Skv // BWD_BN)
    runs = {qt: [] for qt in range(nqt)}
    for kt in range(nkt):
        for qt in bwd_q_tiles(kt * BWD_BN, Sq, Skv, causal, window):
            runs[qt].append(kt)
    keys = torch.arange(Skv)[None, :]
    for qt, kts in runs.items():
        qpos = torch.arange(qt * BWD_BM, min(qt * BWD_BM + BWD_BM, Sq))[:, None]
        ok = torch.ones(len(qpos), Skv, dtype=torch.bool)
        if causal:
            ok &= keys <= qpos
        if window > 0:
            ok &= keys > qpos - window
        kept = set((keys.expand_as(ok)[ok] // BWD_BN).tolist())
        assert kept <= set(kts), (qt, sorted(kept), kts)
        if kts:
            lo = bwd_dq_first_key_tile(qt, Skv, window)
            assert kts == list(range(lo, kts[-1] + 1)), (qt, lo, kts)


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
