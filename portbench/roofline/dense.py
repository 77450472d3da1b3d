"""Counts of the dense decoder family (`reference/dense.py`: GQA
attention, a SwiGLU MLP, tied embeddings), as `counts` takes a family's:
``param_count``, ``active_params``, ``embed_params`` and
``mixing_fwd_flops``."""
from __future__ import annotations

from portbench.roofline.counts import causal_pairs


def param_count(m: dict) -> int:
    """Parameters of the configuration (tied embeddings counted once)."""
    d, L, H, KV = (m["hidden_size"], m["num_hidden_layers"],
                   m["num_attention_heads"], m["num_key_value_heads"])
    Dh, F, V = m["head_dim"], m["intermediate_size"], m["vocab_size"]
    per = d * (H + 2 * KV) * Dh + H * Dh * d + 3 * d * F + 2 * d
    return L * per + V * d + d


def active_params(m: dict) -> int:
    """Parameters that one token's forward uses: every one."""
    return param_count(m)


def embed_params(m: dict) -> int:
    return m["vocab_size"] * m["hidden_size"]


def mixing_fwd_flops(m: dict, rows: int, S: int) -> int:
    """Attention's score and value products over the causal pairs."""
    return (m["num_hidden_layers"] * 4 * rows * m["num_attention_heads"]
            * m["head_dim"] * causal_pairs(S))
