"""Plain float32 reference of Mamba-2 (arXiv:2405.21060), one group of
B and C, with tied input and output embeddings.

One layer: x += mixer(n(x)), n = RMSNorm with the scale (1 + w). The
mixer: [z | xBC | dt] = n(x)·W_in; xBC = silu(causal depthwise conv of
width K over xBC, plus its bias; tap K-1 is the current position);
x_s | B | C = xBC; dt = softplus(dt + dt_bias); A = -exp(a_log); the
state-space recurrence per head h, with state N and head size P,
    H_t = exp(dt_t A) H_{t-1} + dt_t x_t B_tᵀ,    y_t = H_t C_t + D x_t,
computed in the chunked form of the paper (Q positions a chunk: the
quadratic form within a chunk, the recurrence between chunks);
out = (RMSNorm(y * silu(z)) with the scale (1 + w_g))·W_out.

`q` (the precision) is applied to both operands of the projections and
of the head, and to x_s, B and C before the scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

from portbench.reference.dense import head_nll, logits, rmsnorm



def dims(m: dict) -> tuple:
    d = m["d_model"]
    di = m["expand"] * d
    N = m["d_state"]
    H = di // m["headdim"]
    return d, m["n_layer"], di, N, H, m["headdim"], m["d_conv"], m["vocab_size"]


def layout(m: dict) -> dict:
    d, L, di, N, H, P, K, V = dims(m)
    conv = di + 2 * N
    per = {"ln/scale": ((d,), "zeros", 0.0),
           "in_proj": ((d, 2 * di + 2 * N + H), "scaled", 0.0),
           "conv_w": ((K, conv), "normal", 0.1),
           "conv_b": ((conv,), "zeros", 0.0),
           "a_log": ((H,), "ssm_a", 0.0),
           "d_skip": ((H,), "ones", 0.0),
           "dt_bias": ((H,), "zeros", 0.0),
           "gnorm": ((di,), "zeros", 0.0),
           "out_proj": ((di, d), "scaled", 0.0)}
    out = {"embed": ((V, d), "normal", 0.02),
           "final_norm/scale": ((d,), "zeros", 0.0)}
    for k, (shape, init, scale) in per.items():
        out[f"layers/{k}"] = ((L,) + shape, init, scale)
    return out


def segsum(t):
    """out[..., i, j] = t[..., j+1] + ... + t[..., i] for i >= j, else -inf."""
    n = t.shape[-1]
    cs = torch.cumsum(t, -1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(n, n, dtype=torch.bool, device=t.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def scan(x, dt, A, Bm, Cm, chunk: int):
    """y (b, s, h, p) of the recurrence from a zero state. x (b, s, h, p),
    dt (b, s, h), A (h,), Bm, Cm (b, s, n). A sequence that the chunk
    does not divide is padded at its end (dt = 0: no decay, no input)."""
    b, s, h, p = x.shape
    Q = chunk
    pad = (-s) % Q
    if pad:
        x, Bm, Cm = (Fn.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                     for t in (x, Bm, Cm))
        dt = Fn.pad(dt, (0, 0, 0, pad))
    c = (s + pad) // Q
    x = x.reshape(b, c, Q, h, p)
    dt = dt.reshape(b, c, Q, h)
    Bm = Bm.reshape(b, c, Q, -1)
    Cm = Cm.reshape(b, c, Q, -1)
    da = dt * A                                                # (b,c,Q,h)
    cum = torch.cumsum(da, 2)
    decay = torch.exp(segsum(da.permute(0, 1, 3, 2)))          # (b,c,h,Q,Q)
    cb = Cm @ Bm.transpose(-1, -2)                             # (b,c,Q,Q)
    w = cb[:, :, None] * decay * dt.permute(0, 1, 3, 2)[:, :, :, None, :]
    y = torch.einsum("bchqk,bckhp->bcqhp", w, x)
    to_end = torch.exp(cum[:, :, -1:] - cum) * dt              # (b,c,Q,h)
    states = torch.einsum("bckh,bckn,bckhp->bchpn", to_end, Bm, x)
    chunk_decay = torch.exp(cum[:, :, -1])                     # (b,c,h)
    hs, state = [], torch.zeros_like(states[:, 0])
    for i in range(c):
        hs.append(state)
        state = state * chunk_decay[:, i, :, None, None] + states[:, i]
    hs = torch.stack(hs, 1)                                    # (b,c,h,p,n)
    y = y + torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cm, hs, torch.exp(cum))
    return y.reshape(b, c * Q, h, p)[:, :s]


def mixer(m: dict, q, x, lp: dict):
    d, L, di, N, H, P, K, V = dims(m)
    B, S, _ = x.shape
    proj = q(x) @ q(lp["in_proj"])
    z, xbc, dt = torch.split(proj, [di, di + 2 * N, H], -1)
    xp = Fn.pad(xbc, (0, 0, K - 1, 0))
    conv = lp["conv_b"] + sum(xp[:, k:k + S] * lp["conv_w"][k]
                              for k in range(K))
    conv = conv * torch.sigmoid(conv)
    xs, Bm, Cm = torch.split(conv, [di, N, N], -1)
    dt = torch.logaddexp(dt + lp["dt_bias"], torch.zeros((), device=dt.device))
    A = -torch.exp(lp["a_log"])
    xs = xs.reshape(B, S, H, P)
    y = scan(q(xs), dt, A, q(Bm), q(Cm), m["chunk_size"])
    y = (y + xs * lp["d_skip"][:, None]).reshape(B, S, di)
    g = rmsnorm(y * (z * torch.sigmoid(z)), lp["gnorm"], m["rms_norm_eps"])
    return q(g) @ q(lp["out_proj"])


def layer(m: dict, q, x, lp: dict):
    return x + mixer(m, q, rmsnorm(x, lp["ln/scale"], m["rms_norm_eps"]), lp)


def hidden(m: dict, P: dict, tokens, q, remat: bool):
    x = P["embed"][tokens.long()]
    for lp in P["layers"]:
        x = (checkpoint(layer, m, q, x, lp, use_reentrant=False) if remat
             else layer(m, q, x, lp))
    return rmsnorm(x, P["final_norm/scale"], m["rms_norm_eps"])


def nll_sum(m: dict, P: dict, tokens, labels, q):
    return head_nll(q, hidden(m, P, tokens, q, remat=True), labels,
                    P["embed"])


@torch.no_grad()
def last_logits(m: dict, P: dict, tokens, n_last: int, q):
    x = hidden(m, P, tokens, q, remat=False)
    return logits(q, x[:, -n_last:], P["embed"])
