"""Top-k MoE with capacity-bounded dispatch and dense grouped matmuls
(the reference's `src/repro/models/moe.py`, its local path).

The reference has two paths with one semantics: a scatter-based local
path, and an expert-parallel ``shard_map`` over a device mesh. On one
card only the local path has a meaning; it is ported here, op for op:

- the router's product is float32 (the reference's bf16 × bf16 with
  ``preferred_element_type=float32``: products of bf16 values are exact
  in float32, so only the summation order can differ), then a softmax
  and the top k in descending order, ties to the lower expert (a stable
  descending sort, on the CPU and on the card alike);
- capacity is per (sequence × expert): `_capacity` tokens an expert; a
  token's slot is its rank among the assignments to its expert in
  token-major order, and assignments past the capacity are dropped (the
  residual connection carries them);
- the expert FFN runs over all experts' capacity buffers (``ecd,edf``),
  so a decode step reads every expert's weights;
- the combine adds ``out · w_j`` over j = 0…k−1 in the activation dtype,
  rounding after each product and each add, as the reference does.

`moe_apply` returns ``(y, {"lb_loss", "router_dropped"})``.
"""
from __future__ import annotations

import torch

from repro_torch.config import GEGLU, SWIGLU, ModelConfig
from repro_torch.devmath import divide
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((D, E), ("fsdp", None), init="scaled"),
        "wg": ParamSpec((E, D, F), ("expert", "fsdp", None), init="scaled"),
        "wi": ParamSpec((E, D, F), ("expert", "fsdp", None), init="scaled"),
        "wo": ParamSpec((E, F, D), ("expert", None, "fsdp"), init="scaled"),
    }


def _capacity(tokens: int, k: int, n_experts: int, cf: float) -> int:
    return max(int(tokens * k * cf / n_experts) + 1, k)


def _route(cfg: ModelConfig, router, x_flat):
    """x_flat (T, D) -> (weights (T,k), ids (T,k), probs (T,E)), float32
    weights and probs."""
    logits = x_flat.float() @ router.to(x_flat.dtype).float()
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    probs = e / e.sum(dim=-1, keepdim=True)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = top[:, :cfg.top_k], order[:, :cfg.top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, ids, probs


def _expert_ffn(cfg: ModelConfig, buf, wg, wi, wo, dtype):
    """buf (E, C, D) x weights (E, D, F)/(E, F, D) -> (E, C, D)."""
    if cfg.mlp_variant in (SWIGLU, GEGLU):
        act = L.silu if cfg.mlp_variant == SWIGLU else L.gelu
        h = act(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
    else:
        h = L.gelu(torch.bmm(buf, wi))
    return torch.bmm(h, wo)


def _slots(ids, n_experts: int, capacity: int):
    """Whether each assignment is kept, and its slot in its expert's
    buffer clamped to the last one; both (T, k).

    The slot is the rank among the assignments to the same expert in
    token-major order: an exclusive prefix count over the flattened
    (T·k) one-hot. The one-hot is laid out expert-major, (E, T·k), so
    that the count runs along the contiguous dimension: down the
    reference's (T·k, E) layout the card's scan took 19 ms a layer at
    OLMoE's prefill (T·k = 65,536) on an H100. Integer counts: the same
    slots either way."""
    T, k = ids.shape
    rows = torch.arange(n_experts, device=ids.device)
    oh = (rows[:, None] == ids.reshape(1, T * k)).to(torch.int32)
    slot = ((torch.cumsum(oh, dim=1, dtype=torch.int32) - oh) * oh).sum(
        0).reshape(T, k)
    return slot < capacity, torch.clamp(slot, max=capacity - 1)


def _dispatch_combine_local(cfg, x_flat, ids, weights, capacity, ffn):
    """Scatter the tokens into per-expert buffers, run ffn, gather back.

    x_flat (T, D); ids/weights (T, k). Returns (y (T, D), the dropped
    share of the assignments). The reference's function also takes the
    range of experts a mesh shard owns; on one card every expert is
    local.

    Dispatch and combine loop over the k routing choices, so no (T·k, D)
    copy of the tokens is made, and every intermediate stays in the
    activation dtype.
    """
    T, D = x_flat.shape
    k = cfg.top_k
    dtype = x_flat.dtype
    keep, slot_c = _slots(ids, cfg.n_experts, capacity)

    buf = torch.zeros((cfg.n_experts, capacity, D), dtype=dtype,
                      device=x_flat.device)
    for j in range(k):
        contrib = torch.where(keep[:, j, None], x_flat, 0)
        # The accumulating index_put_ sums a cell's terms in an order of
        # its own (on the card, that of its sorted indices; not the
        # reference's). The sum is exact all the same: a kept assignment
        # owns its (expert, slot), so each cell gets at most one non-zero
        # term; the dropped ones add zeros to the clamped last slot.
        buf.index_put_((ids[:, j], slot_c[:, j]), contrib, accumulate=True)

    out_buf = ffn(buf)                                    # (E, C, D)

    y = torch.zeros((T, D), dtype=dtype, device=x_flat.device)
    for j in range(k):
        w_j = torch.where(keep[:, j], weights[:, j], 0.0).to(dtype)
        y = y + out_buf[ids[:, j], slot_c[:, j]] * w_j[:, None]
    drop_frac = 1.0 - divide(keep.sum().float(), T * k)
    return y, drop_frac


def _moe_local_path(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple:
    B, S, D = x.shape
    E = cfg.n_experts
    dtype = x.dtype
    x_flat = x.reshape(B * S, D)
    weights, ids, probs = _route(cfg, p["router"], x_flat)
    me = probs.mean(dim=0)
    # 1/(T·k) added once per assignment, as the reference's scatter-add:
    # equal addends give the same sum in any order, atomics included
    share = torch.full((ids.numel(),), 1.0 / (B * S * cfg.top_k),
                       dtype=torch.float32, device=x.device)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, ids.reshape(-1), share)
    lb = E * torch.sum(me * ce)
    capacity = _capacity(B * S, cfg.top_k, E, cfg.capacity_factor)

    def ffn(buf):
        return _expert_ffn(cfg, buf, p["wg"].to(dtype), p["wi"].to(dtype),
                           p["wo"].to(dtype), dtype)
    y, drop = _dispatch_combine_local(cfg, x_flat, ids, weights, capacity,
                                      ffn)
    return y.reshape(B, S, D), {"lb_loss": lb, "router_dropped": drop}


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple:
    """x: (B, S, D) -> (y (B, S, D), {"lb_loss", "router_dropped"});
    capacity is per sequence group of the batch (the local path)."""
    return _moe_local_path(cfg, p, x)
