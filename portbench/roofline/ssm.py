"""Counts of the Mamba-2 family (`reference/ssm.py`: one group of B and
C, tied embeddings), as `counts` takes a family's: ``param_count``,
``active_params``, ``embed_params`` and ``mixing_fwd_flops``."""
from __future__ import annotations

from portbench.roofline.counts import ssd_products


def param_count(m: dict) -> int:
    """Parameters of the configuration (tied embeddings counted once)."""
    d, L, N, K, V = (m["d_model"], m["n_layer"], m["d_state"],
                     m["d_conv"], m["vocab_size"])
    di = m["expand"] * d
    H = di // m["headdim"]
    conv = di + 2 * N
    per = (d * (2 * di + 2 * N + H) + K * conv + conv + 3 * H + di
           + di * d + d)
    return L * per + V * d + d


def active_params(m: dict) -> int:
    """Parameters that one token's forward uses: every one."""
    return param_count(m)


def embed_params(m: dict) -> int:
    return m["vocab_size"] * m["d_model"]


def mixing_fwd_flops(m: dict, rows: int, S: int) -> int:
    """The SSD's chunked products."""
    di = m["expand"] * m["d_model"]
    Q = min(m["chunk_size"], S)
    return m["n_layer"] * ssd_products(rows, S, di // m["headdim"],
                                       m["headdim"], m["d_state"], Q)
