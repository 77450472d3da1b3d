"""Plain PyTorch oracles for the model kernels: attention, the Mamba-2
SSD scan, the RG-LRU recurrence and the causal depthwise conv.

The semantic ground truth of the port's model path, ported from the
reference's `repro.kernels.ref`: the CUDA kernels' plain versions build
on these, decode steps use them directly, and on the CPU they are what
the model runs (`attention_chunked`, `attention_flash`, `ssd_chunked`
and `rglru_assoc` being the reference's CPU paths).

`attention_flash` is the train-memory-safe attention: an autograd
Function (`FlashAttention`) whose forward keeps only (q, k, v, out,
lse) and whose backward recomputes each block's probabilities
(`_flash_bwd_inner`), as the reference's custom VJP does.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

# A finite "minus infinity": a fully masked row gives uniform weights,
# not NaN, exactly as in the reference.
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def needs_grad(*tensors) -> bool:
    """Whether autograd would need a backward through these inputs: grad
    enabled and one of them (``None`` skipped) requiring grad. A kernel
    without a backward raises then, rather than cut the graph."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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


def _block_bias(q0: int, qb: int, k0: int, kb: int, kv_valid, causal: bool,
                window: int, device):
    """The (qb, kb) additive mask of a (q block, kv block) pair: 0 where
    an edge is kept, NEG_INF elsewhere; None when every edge is kept and
    False when none is. Adding 0 changes no score. A block masked for
    every row changes no result of a row that keeps any key at all: it
    adds exactly 0 after the row's first kept key (p = exp(NEG_INF - m)
    = 0, corr = 1), and whatever it adds before that key is multiplied
    by corr = exp(NEG_INF - m) = 0 there; in the backward its p is 0."""
    q_lo, q_hi, k_lo, k_hi = q0, q0 + qb - 1, k0, k0 + kb - 1
    if k_lo >= kv_valid or (causal and k_lo > q_hi) or (
            window and window > 0 and k_hi <= q_lo - window):
        return False
    if k_hi < kv_valid and (not causal or k_hi <= q_lo) and not (
            window and window > 0 and k_lo <= q_hi - window):
        return None
    q_pos = q0 + torch.arange(qb, device=device)[:, None]
    kv_pos = k0 + torch.arange(kb, device=device)[None, :]
    mask = kv_pos < kv_valid
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if window and window > 0:
        mask = mask & (kv_pos > q_pos - window)
    zero = torch.zeros((), device=device)
    return torch.where(mask, zero, NEG_INF)


def attention_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset=0, kv_len=None, scale: Optional[float] = None,
                      q_block: int = 512, kv_block: int = 1024):
    """Online-softmax (flash-style) attention with bounded temporaries:
    q blocks (outer) x kv blocks (inner carry), padded to block
    multiples; `_flash_fwd_inner` with the queries at `q_offset` and the
    keys past `kv_len` masked. The reference's CPU path for large
    attention that is not plain self-attention (an offset or a partly
    filled cache). A row must keep at least one key (as every causal,
    windowed or cache row does)."""
    B, Sq, Hq, Dh = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else Dh ** -0.5
    qb, kb, sq_p, skv_p = flash_blocks(Sq, Skv, q_block, kv_block)
    out, _ = _flash_fwd_inner(_pad_seq(q, sq_p), _pad_seq(k, skv_p),
                              _pad_seq(v, skv_p), causal, window, scale, qb,
                              kb, Skv if kv_len is None else kv_len,
                              q_offset)
    return out[:, :Sq]


# ---------------------------------------------------------------------------
# Flash attention with a recomputing backward (the reference's custom VJP):
# the backward recomputes each block's probabilities from the row
# log-sum-exp instead of saving them, which keeps training at long
# sequences within memory.
# ---------------------------------------------------------------------------

def _pad_seq(x, n):
    """x (B, S, ...) zero-padded along S to n rows."""
    if x.shape[1] == n:
        return x
    pad = x.new_zeros((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def _heads(x, Hkv, G):
    """(B, S, Hkv·G, Dh) -> (B, Hkv, G, S, Dh)."""
    B, S, _, Dh = x.shape
    return x.reshape(B, S, Hkv, G, Dh).permute(0, 2, 3, 1, 4)


def _flash_fwd_inner(q, k, v, causal, window, scale, q_block, kv_block,
                     kv_valid, q_offset=0):
    """Returns (out (B,Sq,Hq,Dh) in q.dtype, lse (B,Hkv,G,Sq) float32).
    Sq and Skv are block multiples (the callers pad); keys at or past
    `kv_valid` are masked; query i sits at position q_offset + i. lse =
    m + log(max(l, 1e-37)), the natural log of the row's sum of
    exp(scale·q·k) over its kept keys."""
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qb, kb = q_block, kv_block
    qh = _heads(q.float() * scale, Hkv, G)                  # (B,Hkv,G,Sq,Dh)
    kh = k.float().permute(0, 2, 1, 3)                      # (B,Hkv,Skv,Dh)
    vh = v.float().permute(0, 2, 1, 3)
    outs, lses = [], []
    for i in range(Sq // qb):
        qblk = qh[:, :, :, i * qb:(i + 1) * qb]
        m = torch.full((B, Hkv, G, qb, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, qb, 1), device=q.device)
        acc = torch.zeros((B, Hkv, G, qb, Dh), device=q.device)
        for j in range(Skv // kb):
            bias = _block_bias(q_offset + i * qb, qb, j * kb, kb, kv_valid,
                               causal, window, q.device)
            if bias is False:
                continue
            s = torch.matmul(qblk, kh[:, :, None, j * kb:(j + 1) * kb]
                             .transpose(-1, -2))
            if bias is not None:
                s = s + bias
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.matmul(p, vh[:, :, None,
                                                  j * kb:(j + 1) * kb])
            m = m_new
        lc = torch.clamp(l, min=1e-37)
        outs.append(acc / lc)
        lses.append((m + torch.log(lc))[..., 0])
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh)
    return out.to(q.dtype), torch.cat(lses, dim=3)


def _flash_bwd_inner(q, k, v, out, lse, dout, causal, window, scale,
                     q_block, kv_block, kv_valid):
    """(dq, dk, dv) in the dtypes of q, k, v, computed in float32 from
    the saved (q, k, v, out, lse (B,Hkv,G,Sq)) and dout, one (q block,
    kv block) pair at a time; Sq and Skv block multiples. Pairs masked
    for every row are skipped: their probabilities are exactly 0."""
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qb, kb = q_block, kv_block
    nq = Sq // qb

    def blocks(x):      # (B,Sq,Hq,Dh) -> (B,Hkv,nq,G,qb,Dh), f32
        return x.float().reshape(B, nq, qb, Hkv, G, Dh).permute(
            0, 3, 1, 4, 2, 5).contiguous()

    qh, oh, doh = blocks(q), blocks(out), blocks(dout)
    kh = k.float().permute(0, 2, 1, 3).contiguous()         # (B,Hkv,Skv,Dh)
    vh = v.float().permute(0, 2, 1, 3).contiguous()
    lseh = lse.float().reshape(B, Hkv, G, nq, qb).transpose(2, 3)
    delta = (doh * oh).sum(-1)                              # D_i = rowsum(dO·O)
    dq = torch.zeros_like(qh)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    for i in range(nq):
        qblk = qh[:, :, i].reshape(B, Hkv, G * qb, Dh)
        doblk = doh[:, :, i].reshape(B, Hkv, G * qb, Dh)
        lse_i = lseh[:, :, i].reshape(B, Hkv, G * qb, 1)
        d_i = delta[:, :, i].reshape(B, Hkv, G * qb, 1)
        dq_i = dq[:, :, i].view(B, Hkv, G * qb, Dh)
        for j in range(Skv // kb):
            bias = _block_bias(i * qb, qb, j * kb, kb, kv_valid, causal,
                               window, q.device)
            if bias is False:
                continue
            cols = slice(j * kb, (j + 1) * kb)
            kblk, vblk = kh[:, :, cols], vh[:, :, cols]
            s = torch.matmul(qblk * scale, kblk.transpose(-1, -2))
            if bias is not None:
                s = (s.view(B, Hkv, G, qb, kb) + bias).view(B, Hkv, G * qb, kb)
            p = torch.exp(s - lse_i)                        # (B,Hkv,G·qb,kb)
            dv[:, :, cols] += torch.matmul(p.transpose(-1, -2), doblk)
            dp = torch.matmul(doblk, vblk.transpose(-1, -2))
            ds = p * (dp - d_i)
            dq_i += torch.matmul(ds, kblk) * scale
            dk[:, :, cols] += torch.matmul(ds.transpose(-1, -2), qblk) * scale
    dq = dq.permute(0, 2, 4, 1, 3, 5).reshape(B, Sq, Hq, Dh)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_blocks(Sq: int, Skv: int, q_block: int = 512,
                 kv_block: int = 1024) -> tuple:
    """(q block, kv block, padded Sq, padded Skv) of `attention_flash`."""
    qb, kb = min(q_block, Sq), min(kv_block, Skv)
    return qb, kb, -(-Sq // qb) * qb, -(-Skv // kb) * kb


def flash_fwd_torch(q, k, v, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, q_block: int = 512,
                    kv_block: int = 1024) -> tuple:
    """(out (B,Sq,Hq,Dh), lse (B,Hq,Sq) float32) by `_flash_fwd_inner` on
    inputs padded to block multiples; the plain version of the flash
    kernel's forward with its log-sum-exp (head h = hkv·G + g)."""
    B, Sq, Hq, Dh = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else Dh ** -0.5
    qb, kb, sq_p, skv_p = flash_blocks(Sq, Skv, q_block, kv_block)
    out, lse = _flash_fwd_inner(_pad_seq(q, sq_p), _pad_seq(k, skv_p),
                                _pad_seq(v, skv_p), causal, window, scale,
                                qb, kb, Skv)
    return out[:, :Sq], lse.reshape(B, Hq, sq_p)[:, :, :Sq]


class FlashAttention(torch.autograd.Function):
    """Flash attention whose backward recomputes: the forward
    (`flash_fwd_torch`) saves (q, k, v, out, lse); the backward is
    `flash_bwd_torch` on them. Self-attention: q and kv positions both
    start at 0."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_block, kv_block):
        scale = scale if scale is not None else q.shape[3] ** -0.5
        out, lse = flash_fwd_torch(q, k, v, causal, window, scale, q_block,
                                   kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_torch(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_bwd_torch(q, k, v, out, lse, dout, causal, window, scale,
                    q_block: int = 512, kv_block: int = 1024) -> tuple:
    """(dq, dk, dv) of flash attention from the saved (q, k, v, out, lse
    (B,Hq,Sq)) and dout: `_flash_bwd_inner` on inputs padded to the
    blocks of `flash_blocks` (padded rows carry a zero dout and a zero
    lse, so they add nothing). The backward of `FlashAttention`."""
    B, Sq, Hq, _ = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qb, kb, sq_p, skv_p = flash_blocks(Sq, Skv, q_block, kv_block)
    lse_p = lse.new_zeros((B, Hq, sq_p))
    lse_p[:, :, :Sq] = lse
    dq, dk, dv = _flash_bwd_inner(
        _pad_seq(q, sq_p), _pad_seq(k, skv_p), _pad_seq(v, skv_p),
        _pad_seq(out, sq_p), lse_p.reshape(B, Hkv, Hq // Hkv, sq_p),
        _pad_seq(dout.contiguous(), sq_p), causal, window, scale, qb, kb, Skv)
    return dq[:, :Sq], dk[:, :Skv], dv[:, :Skv]


def attention_flash(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, q_block: int = 512,
                    kv_block: int = 1024) -> torch.Tensor:
    """Flash attention in plain PyTorch with a recomputing backward; self-
    attention only (train and prefill paths). q (B,Sq,Hq,Dh); k, v
    (B,Skv,Hkv,Dh)."""
    return FlashAttention.apply(q, k, v, causal, window or 0, scale, q_block,
                                kv_block)


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


def ssd_chunked_bwd_torch(x, dt, a_log, b, c, d, dy, dh_final=None,
                          chunk: int = 256) -> tuple:
    """Gradients (dx, ddt, da_log, db, dc, dd), each in its input's dtype,
    of `ssd_chunked` from a zero state at `chunk`, given the gradients
    ``dy`` of y and ``dh_final`` of h_final (``None``: zero): autograd
    through `ssd_chunked` (which computes in float32), recomputed from
    the inputs as they are. The reference's gradient through the SSD is
    JAX's autodiff of that function (it has no backward kernel); the
    backward of the SSD kernel's autograd Function."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c,
                                                         d)]
        y, h = ssd_chunked(*leaves, chunk=chunk)
        outs, grads = [y], [dy.to(y.dtype)]
        if dh_final is not None:
            outs.append(h)
            grads.append(dh_final.float())
        return torch.autograd.grad(outs, leaves, grads)


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


@functools.cache
def _cpu_math_warmed(n_threads: int) -> bool:
    """Run float32 exp, expm1 and sqrt once on every intra-op thread.

    On the CPU, a process's first exp or sqrt call on a freshly started
    intra-op thread can return that thread's chunk (2,048 entries) up
    to 1.5e-4 relative off; the thread's later calls are exact. Each op
    here runs over n_threads × 4,096 entries, at least one chunk on
    every thread, before the gates' first CPU call."""
    t = torch.zeros(n_threads * 4096)
    for op in (torch.exp, torch.expm1, torch.sqrt):
        op(t)
    return True


def rglru_gates(x, r, i, lam):
    """The RG-LRU's decay and gated input, in float32:
    a = exp(-c·softplus(lam)·σ(r)), gx = √(1 - a²)·σ(i)·x. On the CPU the
    transcendental ops are warmed on every thread first
    (`_cpu_math_warmed`)."""
    if x.device.type == "cpu":
        _cpu_math_warmed(torch.get_num_threads())
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


def rglru_scan_bwd_torch(a, h_seq, h0, dy, dh_last=None) -> tuple:
    """Gradients (da in a's dtype, dgx, dh0 float32) of the recurrence
    h_t = a_t·h_{t-1} + gx_t from h0, given its states ``h_seq`` (B,S,W),
    the gradients ``dy`` of h_seq and ``dh_last`` of the last state
    (``None``: zero): the plain reverse loop. With g_t the gradient at
    h_t, g_{S-1} = dy_{S-1} + dh_last and g_t = a_{t+1}·g_{t+1} + dy_t
    (the forward's recurrence run backwards, with the forward's roundings:
    one float32 product, then one sum); then dgx_t = g_t, da_t =
    g_t·h_{t-1} with h_{-1} = h0, and dh0 = a_0·g_0."""
    B, S, W = a.shape
    g = (torch.zeros(B, W, device=a.device) if dh_last is None
         else dh_last.float())
    one = torch.ones(B, W, device=a.device)
    gs = [None] * S
    for t in range(S - 1, -1, -1):
        a_next = a[:, t + 1].float() if t + 1 < S else one
        g = a_next * g + dy[:, t].float()
        gs[t] = g
    return rglru_grads_from_g(a, h_seq, h0, torch.stack(gs, 1))


def rglru_grads_from_g(a, h_seq, h0, g) -> tuple:
    """(da in a's dtype, dgx, dh0) of the RG-LRU recurrence from g (B,S,W)
    float32, the gradient at each state (`rglru_scan_bwd_torch`)."""
    h_prev = torch.cat([h0.float()[:, None], h_seq[:, :-1].float()], 1)
    return (g * h_prev).to(a.dtype), g, a[:, 0].float() * g[:, 0]


def rglru_assoc(x, r, i, lam, h0=None, scan_scope=None):
    """RG-LRU by a log-depth scan over time (Hillis-Steele doubling with
    the combine (a1, b1), (a2, b2) -> (a1·a2, a2·b1 + b2)): the
    counterpart of the reference's ``associative_scan`` path, its CPU
    path. Same contract as `rglru_ref`. The scan (not the gates or the
    cast) runs inside ``scan_scope``, a context manager, where given."""
    a, gx = rglru_gates(x, r, i, lam)
    with scan_scope or contextlib.nullcontext():
        if h0 is not None:
            gx = gx.clone()
            gx[:, 0] += a[:, 0] * h0.float()    # h_1 = a_1·h0 + gx_1
        S = x.shape[1]
        step = 1
        while step < S:
            b_new = gx.clone()
            b_new[:, step:] = a[:, step:] * gx[:, :-step] + gx[:, step:]
            a_new = a.clone()
            a_new[:, step:] = a[:, :-step] * a[:, step:]
            a, gx = a_new, b_new
            step *= 2
        h_last = gx[:, -1].clone()
    return gx.to(x.dtype), h_last


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
