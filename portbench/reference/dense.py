"""Plain float32 reference of the decoder-only transformer with grouped-
query attention, RoPE and a SwiGLU MLP (SmolLM-135M's Llama-style block),
with tied input and output embeddings.

One layer: x += Wo·attn(rope(Wq·n1(x)), rope(Wk·n1(x)), Wv·n1(x));
x += Wo'·(silu(Wg·n2(x)) * Wi·n2(x)); n = RMSNorm with the scale
written as (1 + w) (w starts at 0: the published form's scale starts at
1). Attention is causal, softmax(q·kᵀ / sqrt(Dh)), each key-value head
shared by Hq / Hkv consecutive query heads. RoPE rotates the two halves
of each head (θ = rope_theta). Logits = n_f(x)·Eᵀ.

`q` (the precision, `common.PRECISIONS`) is applied to both operands of
every matrix product; float32 leaves them as they are.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
Q_BLOCK = 512          # query rows of one attention block
CE_BLOCK = 512         # positions of one cross-entropy block


def dims(m: dict) -> tuple:
    return (m["hidden_size"], m["num_hidden_layers"], m["num_attention_heads"],
            m["num_key_value_heads"], m["head_dim"], m["intermediate_size"],
            m["vocab_size"])


def layout(m: dict) -> dict:
    """{path: (shape, init, scale)} of the parameter tree."""
    d, L, H, KV, Dh, F, V = dims(m)
    per = {"ln1/scale": ((d,), "zeros"),
           "attn/wq": ((d, H * Dh), "scaled"),
           "attn/wk": ((d, KV * Dh), "scaled"),
           "attn/wv": ((d, KV * Dh), "scaled"),
           "attn/wo": ((H * Dh, d), "scaled"),
           "ln2/scale": ((d,), "zeros"),
           "mlp/wg": ((d, F), "scaled"),
           "mlp/wi": ((d, F), "scaled"),
           "mlp/wo": ((F, d), "scaled")}
    out = {"embed": ((V, d), "normal", 0.02),
           "final_norm/scale": ((d,), "zeros", 0.0)}
    for k, (shape, init) in per.items():
        out[f"layers/{k}"] = ((L,) + shape, init, 0.0)
    return out


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * (1.0 + w)


def rope(x, theta):
    """x (B, S, H, Dh): the two halves of each head rotated by position
    times theta^(-i / half)."""
    S, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * freqs[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(q, k, v):
    """Causal GQA, q (B, S, H, Dh), k, v (B, S, KV, Dh), in blocks of
    query rows (each block against the keys up to its last row)."""
    B, S, H, Dh = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)          # (B,H,S,Dh)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    qt = q.transpose(1, 2) * Dh ** -0.5
    outs = []
    for r0 in range(0, S, Q_BLOCK):
        r1 = min(r0 + Q_BLOCK, S)
        s = qt[:, :, r0:r1] @ k[:, :, :r1].transpose(-1, -2)     # (B,H,r,r1)
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        keep = torch.arange(r1, device=q.device)[None, :] <= rows
        s = s.masked_fill(~keep, float("-inf"))
        outs.append(torch.softmax(s, -1) @ v[:, :, :r1])
    return torch.cat(outs, 2).transpose(1, 2)                 # (B,S,H,Dh)


def layer(m: dict, q, x, lp: dict):
    d, L, H, KV, Dh, F, V = dims(m)
    B, S, _ = x.shape
    eps = m["rms_norm_eps"]
    mm = lambda a, w: q(a) @ q(w)  # noqa: E731
    h = rmsnorm(x, lp["ln1/scale"], eps)
    qh = rope(mm(h, lp["attn/wq"]).reshape(B, S, H, Dh), m["rope_theta"])
    kh = rope(mm(h, lp["attn/wk"]).reshape(B, S, KV, Dh), m["rope_theta"])
    vh = mm(h, lp["attn/wv"]).reshape(B, S, KV, Dh)
    x = x + mm(attention(q(qh), q(kh), q(vh)).reshape(B, S, H * Dh),
               lp["attn/wo"])
    h = rmsnorm(x, lp["ln2/scale"], eps)
    g = mm(h, lp["mlp/wg"])
    return x + mm(g * torch.sigmoid(g) * mm(h, lp["mlp/wi"]), lp["mlp/wo"])


def hidden(m: dict, P: dict, tokens, q, remat: bool):
    """Final-norm hidden states (B, S, d) of `tokens`; with `remat` each
    layer is recomputed in the backward."""
    x = P["embed"][tokens.long()]
    for lp in P["layers"]:
        x = (checkpoint(layer, m, q, x, lp, use_reentrant=False) if remat
             else layer(m, q, x, lp))
    return rmsnorm(x, P["final_norm/scale"], m["rms_norm_eps"])


def logits(q, x, embed):
    return q(x) @ q(embed).T


def _ce(q, x, labels, embed):
    z = logits(q, x, embed)
    return (torch.logsumexp(z, -1)
            - torch.gather(z, -1, labels.long()[..., None])[..., 0]).sum()


def head_nll(q, x, labels, embed):
    """Sum of the next-token NLLs of hidden states `x` (every label
    valid), in blocks of positions each recomputed in the backward."""
    total = torch.zeros((), dtype=F32, device=x.device)
    for c0 in range(0, x.shape[1], CE_BLOCK):
        total = total + checkpoint(_ce, q, x[:, c0:c0 + CE_BLOCK],
                                   labels[:, c0:c0 + CE_BLOCK], embed,
                                   use_reentrant=False)
    return total


def nll_sum(m: dict, P: dict, tokens, labels, q):
    """Sum of the next-token NLLs of a row block."""
    return head_nll(q, hidden(m, P, tokens, q, remat=True), labels,
                    P["embed"])


@torch.no_grad()
def last_logits(m: dict, P: dict, tokens, n_last: int, q):
    """Logits (B, n_last, V) of the last `n_last` positions."""
    x = hidden(m, P, tokens, q, remat=False)
    return logits(q, x[:, -n_last:], P["embed"])
