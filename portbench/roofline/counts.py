"""The benchmark's yardstick: the card's peaks, and the operations and
bytes that each measured piece of work needs.

Frozen here, so that a change to the program cannot move it. The
formulas follow the program's own cost table and model-FLOP count
(`repro_torch/kernels/cost.py`, `repro_torch/launch/dryrun_lib.py
train_model_flops`) with one rule of their own, the bound rule: a bound
counts the work the mathematics needs for these inputs, whatever
implements it, at the peak of the inputs' dtype.

- Attention backward: the dV, dP, dQ and dK products over the kept
  (query, key) pairs, 8·B·Hq·Dh·pairs. The recompute of the scores and
  probabilities that a recomputing backward does (cost.py counts it:
  10·B·Hq·Dh·pairs) is not counted. Bytes: q, k, v, out, dout read and
  dq, dk, dv written once each, and the float32 row log-sum-exp read.
- SSD backward: 2 × the forward's chunked products (cost.py counts 3 ×,
  the recompute included). Bytes: x, B, C, dy read and dx, dB, dC
  written in the inputs' dtype; dt read and its gradient written in
  float32.
- Forward kernels (flash attention with its log-sum-exp, the SSD scan)
  as cost.py counts them.
- Every bound at bf16's rates: 989 TFLOP/s dense and 3.35 TB/s.

A model family's parameter and token-mixing counts, which the model
FLOPs take, sit in a module of their own, ``roofline/<family>.py``
(`family`), so that a new family comes as a new file.
"""
from __future__ import annotations

import importlib

PEAK_FLOPS_BF16 = 989e12      # H100 SXM data sheet, dense bf16
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
BF16 = 2
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the bf16 peak and the bytes at the memory bandwidth."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES)


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal mask keeps over S positions."""
    return S * (S + 1) // 2


# ---------------------------------------------------------------------------
# Attention (GQA, causal, self-attention)
# ---------------------------------------------------------------------------

def _attn_io(B, S, Hq, Hkv, Dh, item) -> int:
    """q and out (B, S, Hq, Dh), k and v (B, S, Hkv, Dh)."""
    return item * (2 * B * S * Hq * Dh + 2 * B * S * Hkv * Dh)


def flash_fwd(B, S, Hq, Hkv, Dh, item=BF16, lse=True) -> tuple:
    """One causal forward: the score and value products over the kept
    pairs (4·B·Hq·Dh·pairs); q, k, v read, out written, and with `lse`
    the float32 log-sum-exp (B, Hq, S) written."""
    flops = 4 * B * Hq * Dh * causal_pairs(S)
    nbytes = _attn_io(B, S, Hq, Hkv, Dh, item) + (F32 * B * Hq * S if lse
                                                   else 0)
    return flops, nbytes


def attn_bwd(B, S, Hq, Hkv, Dh, item=BF16) -> tuple:
    """One causal backward under the bound rule: 8·B·Hq·Dh·pairs; q, k,
    v, out, dout and lse read, dq, dk, dv written."""
    flops = 8 * B * Hq * Dh * causal_pairs(S)
    nbytes = (_attn_io(B, S, Hq, Hkv, Dh, item)       # q, k, v, out
              + item * B * S * Hq * Dh                 # dout
              + F32 * B * Hq * S                       # lse
              + item * (B * S * Hq * Dh + 2 * B * S * Hkv * Dh))  # dq,dk,dv
    return flops, nbytes


# ---------------------------------------------------------------------------
# Mamba-2 SSD (one group, zero initial state)
# ---------------------------------------------------------------------------

def ssd_products(B, S, H, P, N, Q) -> int:
    """The chunked form's products: C·Bᵀ a chunk (shared by the heads),
    then per head the Q × Q product with x, the chunk's state and the
    entering state's contribution."""
    return B * (S // Q) * (2 * Q * Q * N + H * (2 * Q * Q * P + 4 * Q * P * N))


def ssd_fwd(B, S, H, P, N, Q, item=BF16) -> tuple:
    """One scan: x, B, C read and y written in the inputs' dtype; dt,
    a_log, D read and the final state written in float32."""
    Q = min(Q, S)
    nbytes = (item * (2 * B * S * H * P + 2 * B * S * N)
              + F32 * (B * S * H + 2 * H + B * H * P * N))
    return ssd_products(B, S, H, P, N, Q), nbytes


def ssd_bwd(B, S, H, P, N, Q, item=BF16) -> tuple:
    """One backward under the bound rule: 2 × the forward's products;
    x, B, C, dy read and dx, dB, dC written in the inputs' dtype, dt
    read and ddt written in float32."""
    Q = min(Q, S)
    nbytes = (item * (2 * B * S * H * P + 4 * B * S * N)
              + 2 * F32 * B * S * H)
    return 2 * ssd_products(B, S, H, P, N, Q), nbytes


# ---------------------------------------------------------------------------
# Model FLOPs (mfu), by family
# ---------------------------------------------------------------------------

def family(name: str):
    """The counts of model family `name`: the module ``roofline/<name>.py``
    with ``param_count(m)``, ``active_params(m)`` (the parameters one
    token's forward uses: all of them but in a sparse model),
    ``embed_params(m)`` and ``mixing_fwd_flops(m, rows, S)`` (the
    forward's token-mixing products over `rows` sequences of S)."""
    return importlib.import_module(f"portbench.roofline.{name}")


def param_count(family_name: str, m: dict) -> int:
    """Parameters of the configuration (tied embeddings counted once)."""
    return family(family_name).param_count(m)


def mixing_fwd_flops(family_name: str, m: dict, rows: int, S: int) -> int:
    return family(family_name).mixing_fwd_flops(m, rows, S)


def embed_params(family_name: str, m: dict) -> int:
    return family(family_name).embed_params(m)


def train_step_flops(family_name: str, m: dict, rows: int, S: int) -> float:
    """Model FLOPs of one training step: 6 × the active parameters ×
    tokens, plus 3 × the forward's token-mixing products (no recompute
    counted)."""
    fam = family(family_name)
    return (6.0 * fam.active_params(m) * rows * S
            + 3 * fam.mixing_fwd_flops(m, rows, S))


def serve_flops(family_name: str, m: dict, rows: int, S: int,
                decode_steps: int) -> float:
    """Model FLOPs of serving `rows` prompts of S tokens: the prefill (2 ×
    the active parameters outside the embedding a token, the token-mixing
    products, and the head at the last position of each row) and
    `decode_steps` decode steps (2 × every active parameter a row)."""
    fam = family(family_name)
    n, e = fam.active_params(m), fam.embed_params(m)
    prefill = (2.0 * (n - e) * rows * S + fam.mixing_fwd_flops(m, rows, S)
               + 2.0 * e * rows)
    return prefill + 2.0 * n * rows * decode_steps
