"""Plain PyTorch oracles for the model kernels: attention, the Mamba-2
SSD scan, the RG-LRU recurrence and the causal depthwise conv.

The semantic ground truth of the port's model path, ported from the
reference's `repro.kernels.ref`: the CUDA kernels' plain versions build
on these, decode steps use them directly, and on the CPU they are what
the model runs (`ssd_chunked` and `rglru_assoc` being the reference's
CPU paths).
"""
from __future__ import annotations

from typing import Optional

import torch

# A finite "minus infinity": a fully masked row gives uniform weights,
# not NaN, exactly as in the reference.
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _attn_mask(sq: int, skv: int, q_offset, kv_len, causal: bool, window: int,
               kv_positions=None, device=None) -> torch.Tensor:
    """(sq, skv) boolean mask of allowed attention edges (True = keep)."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]     # (sq, 1)
    if kv_positions is None:
        kv_pos = torch.arange(skv, device=device)[None, :]          # (1, skv)
    else:
        kv_pos = torch.as_tensor(kv_positions, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos <= q_pos
    if window and window > 0:
        mask &= kv_pos > q_pos - window
    if kv_len is not None:
        mask &= kv_pos < kv_len
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset=0, kv_len=None, kv_positions=None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Materializing GQA attention.

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh); Hq % Hkv == 0.
    q_offset: absolute position of q[0].
    kv_len:   number of valid KV entries (for partially-filled caches).
    kv_positions: (Skv,) absolute positions of KV entries (ring buffers).
    Softmax in float32; the output is in q's dtype.
    """
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, Dh).float() * scale
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())  # (B,Hkv,G,Sq,Skv)
    mask = _attn_mask(Sq, Skv, q_offset, kv_len, causal, window, kv_positions,
                      device=q.device)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(B, Sq, Hq, Dh).to(q.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) = logaddexp(x, 0), with no
    threshold (``F.softplus`` returns x above 20; the reference does not)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality)
# ---------------------------------------------------------------------------

def ssd_ref(x, dt, a_log, b, c, d, h0=None):
    """Exact sequential SSD recurrence (the oracle).

    x (B,S,H,P); dt (B,S,H) softplus'd step (> 0); a_log (H,) with
    A = -exp(a_log); b, c (B,S,G,N), H % G == 0; d (H,) skip; h0
    (B,H,P,N). Returns (y (B,S,H,P) in x.dtype, h_final (B,H,P,N) f32).
    """
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    a = -torch.exp(a_log.float())
    bh = b.repeat_interleave(rep, dim=2).float()
    ch = c.repeat_interleave(rep, dim=2).float()
    xf, dtf = x.float(), dt.float()
    h = (torch.zeros(B, H, P, N, device=x.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t] * a)                            # (B,H)
        h = h * da[..., None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", xf[:, t], bh[:, t], dtf[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, ch[:, t]))
    y = torch.stack(ys, 1) + xf * d.float()[None, None, :, None]
    return y.to(x.dtype), h


def _segsum(t: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < m <= i} t[..., m] for i >= j, else -inf."""
    n = t.shape[-1]
    cs = torch.cumsum(t, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(n, device=t.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, out, float("-inf"))


def ssd_chunked(x, dt, a_log, b, c, d, h0=None, chunk: int = 256):
    """Chunked SSD (the Mamba-2 paper's algorithm): dense intra-chunk
    products and a sequential carry of the state between chunks. Same
    contract as `ssd_ref`; the reference's CPU path."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q
    a = -torch.exp(a_log.float())
    xf = x.reshape(B, nc, Q, H, P).float()
    dtf = dt.reshape(B, nc, Q, H).float()
    bh = b.repeat_interleave(rep, dim=2).reshape(B, nc, Q, H, N).float()
    ch = c.repeat_interleave(rep, dim=2).reshape(B, nc, Q, H, N).float()

    da = dtf * a                                                 # (B,nc,Q,H)
    cum = torch.cumsum(da, dim=2)
    L = torch.exp(_segsum(da.permute(0, 1, 3, 2)))               # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", ch, bh)
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", scores * L, dtf, xf)

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)            # (B,nc,Q,H)
    states = torch.einsum("bckh,bckh,bckhn,bckhp->bchpn",
                          decay_to_end, dtf, bh, xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # (B,nc,H)
    h = (torch.zeros(B, H, P, N, device=x.device) if h0 is None
         else h0.float())
    h_in = []
    for ci in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, ci, :, None, None] + states[:, ci]
    h_in = torch.stack(h_in, 1)                                  # (B,nc,H,P,N)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", ch, h_in, torch.exp(cum))
    y = (y_diag + y_off).reshape(B, S, H, P)
    y = y + x.float() * d.float()[None, None, :, None]
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


def rglru_gates(x, r, i, lam):
    """The RG-LRU's decay and gated input, in float32:
    a = exp(-c·softplus(lam)·σ(r)), gx = √(1 - a²)·σ(i)·x."""
    log_a_base = -RGLRU_C * softplus(lam.float())
    rg = torch.sigmoid(r.float())
    ig = torch.sigmoid(i.float())
    log_a = log_a_base * rg
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, beta * (ig * x.float())


def rglru_ref(x, r, i, lam, h0=None):
    """Exact sequential RG-LRU (the oracle). x, r, i (B,S,W); lam (W,);
    h0 (B,W). Returns (h (B,S,W) in x.dtype, h_final (B,W) f32)."""
    B, S, W = x.shape
    a, gx = rglru_gates(x, r, i, lam)
    h = torch.zeros(B, W, device=x.device) if h0 is None else h0.float()
    hs = []
    for t in range(S):
        h = a[:, t] * h + gx[:, t]
        hs.append(h)
    return torch.stack(hs, 1).to(x.dtype), h


def rglru_assoc(x, r, i, lam, h0=None):
    """RG-LRU by a log-depth scan over time (Hillis-Steele doubling with
    the combine (a1, b1), (a2, b2) -> (a1·a2, a2·b1 + b2)): the
    counterpart of the reference's ``associative_scan`` path, its CPU
    path. Same contract as `rglru_ref`."""
    a, gx = rglru_gates(x, r, i, lam)
    if h0 is not None:
        gx = gx.clone()
        gx[:, 0] += a[:, 0] * h0.float()        # h_1 = a_1·h0 + gx_1
    S = x.shape[1]
    step = 1
    while step < S:
        b_new = gx.clone()
        b_new[:, step:] = a[:, step:] * gx[:, :-step] + gx[:, step:]
        a_new = a.clone()
        a_new[:, step:] = a[:, :-step] * a[:, step:]
        a, gx = a_new, b_new
        step *= 2
    return gx.to(x.dtype), gx[:, -1].clone()


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (Mamba-2 and RecurrentGemma front ends)
# ---------------------------------------------------------------------------

def causal_conv1d_ref(x, w, b=None, state=None):
    """Depthwise causal conv. x (B,S,C), w (K,C), state (B,K-1,C) history.
    Returns (y (B,S,C) in x.dtype, new_state (B,K-1,C): the last K-1
    inputs)."""
    B, S, C = x.shape
    K = w.shape[0]
    hist = (torch.zeros(B, K - 1, C, dtype=x.dtype, device=x.device)
            if state is None else state.to(x.dtype))
    xp = torch.cat([hist, x], dim=1)                             # (B,S+K-1,C)
    y = torch.zeros(B, S, C, device=x.device)
    for k in range(K):
        y = y + xp[:, k:k + S].float() * w[k].float()
    if b is not None:
        y = y + b.float()
    # a copy, not a view: a view would keep the whole (B, S+K-1, C) input
    # alive for as long as the cache holds the state
    return y.to(x.dtype), xp[:, S:].clone()
