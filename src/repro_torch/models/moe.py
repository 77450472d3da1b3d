"""Top-k MoE with capacity-bounded dispatch and dense grouped matmuls
(the reference's `src/repro/models/moe.py`).

Two paths, chosen as the reference chooses them (`moe_apply`):

- the local path, on one card or without a mesh: every expert is
  local, and capacity is per batch × expert (`_capacity` of the B·S
  tokens of the call);
- the expert-parallel path, on a mesh with a ``model`` axis (of any
  size, 1 included): each process routes the tokens of its batch rows
  (replicated over ``model``), keeps only the assignments to the
  experts its ``model`` shard owns, gathers the layer's expert weights
  over ``data`` in the activation dtype, runs them, and the partial
  outputs are summed over ``model`` (the reference's psum combine).
  Capacity is per token shard × expert: `_capacity` of the
  (B / batch shards) · S tokens of one process. Where the batch axes do
  not divide B, the model axis does not divide the experts or the data
  axis does not divide d_model, the local path runs over the whole
  batch instead (the reference's fallback; it changes the capacity).

Op for op as the reference:

- the router's product is float32 (the reference's bf16 × bf16 with
  ``preferred_element_type=float32``: products of bf16 values are exact
  in float32, so only the summation order can differ), then a softmax
  and the top k in descending order, ties to the lower expert (a stable
  descending sort, on the CPU and on the card alike);
- a token's slot is its rank among the local assignments to its expert
  in token-major order, and assignments past the capacity are dropped
  (the residual connection carries them); the dropped share counts the
  local assignments only;
- the expert FFN runs over all local experts' capacity buffers
  (``ecd,edf``), so a decode step reads every local expert's weights;
- the combine adds ``out · w_j`` over j = 0…k−1 in the activation dtype,
  rounding after each product and each add, as the reference does.

`moe_apply` returns ``(y, {"lb_loss", "router_dropped"})``; on a mesh
both are the means over the batch and model shards, equal on every
process.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import GEGLU, SWIGLU, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec
from repro_torch.models.sharding import (logical_to_pspec, redistribute,
                                         use_weight)


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
    buffer clamped to the last one; both (T, k). `ids` are local expert
    ids, ``n_experts`` (or more) for an assignment to no local expert,
    which is never kept.

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
    return (slot < capacity) & (ids < n_experts), torch.clamp(
        slot, max=capacity - 1)


def _dispatch_combine_local(cfg, x_flat, ids, weights, capacity, ffn,
                            e0: int = 0, n_local: int = 0):
    """Scatter the tokens into the local experts' buffers, run ffn,
    gather back.

    x_flat (T, D); ids/weights (T, k); experts [e0, e0 + n_local) are
    local (n_local 0: all E of them, as on one card). Returns
    (y (T, D): the local experts' contributions only, the dropped share
    of the local assignments).

    Dispatch and combine loop over the k routing choices, so no (T·k, D)
    copy of the tokens is made, and every intermediate stays in the
    activation dtype.
    """
    T, D = x_flat.shape
    k = cfg.top_k
    dtype = x_flat.dtype
    n_local = n_local or cfg.n_experts
    local = (ids >= e0) & (ids < e0 + n_local)
    keep, slot_c = _slots(torch.where(local, ids - e0, n_local), n_local,
                          capacity)
    e_loc = torch.where(local, ids - e0, 0)

    buf = torch.zeros((n_local, capacity, D), dtype=dtype,
                      device=x_flat.device)
    for j in range(k):
        contrib = torch.where(keep[:, j, None], x_flat, 0)
        # The accumulating index_put_ sums a cell's terms in an order of
        # its own (on the card, that of its sorted indices; not the
        # reference's). The sum is exact all the same: a kept assignment
        # owns its (expert, slot), so each cell gets at most one non-zero
        # term; the dropped ones add zeros to the clamped last slot, the
        # ones to other shards' experts zeros to local expert 0.
        buf.index_put_((e_loc[:, j], slot_c[:, j]), contrib, accumulate=True)

    out_buf = ffn(buf)                                    # (n_local, C, D)

    y = torch.zeros((T, D), dtype=dtype, device=x_flat.device)
    for j in range(k):
        w_j = torch.where(keep[:, j], weights[:, j], 0.0).to(dtype)
        y = y + out_buf[e_loc[:, j], slot_c[:, j]] * w_j[:, None]
    drop_frac = 1.0 - (keep.sum().float()
                       / local.sum().clamp(min=1).float())
    return y, drop_frac


def _lb_loss(cfg: ModelConfig, ids, probs):
    """The load-balancing loss of T routed tokens: E · Σ_e (mean router
    probability of e) × (share of the T·k assignments to e)."""
    E = cfg.n_experts
    me = probs.mean(dim=0)
    # 1/(T·k) added once per assignment, as the reference's scatter-add:
    # equal addends give the same sum in any order, atomics included
    share = torch.full((ids.numel(),), 1.0 / ids.numel(),
                       dtype=torch.float32, device=ids.device)
    ce = torch.zeros(E, dtype=torch.float32, device=ids.device).index_add_(
        0, ids.reshape(-1), share)
    return E * torch.sum(me * ce)


def _moe_local_path(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple:
    B, S, D = x.shape
    E = cfg.n_experts
    dtype = x.dtype
    x_flat = x.reshape(B * S, D)
    weights, ids, probs = _route(cfg, p["router"], x_flat)
    lb = _lb_loss(cfg, ids, probs)
    capacity = _capacity(B * S, cfg.top_k, E, cfg.capacity_factor)

    def ffn(buf):
        return _expert_ffn(cfg, buf, p["wg"].to(dtype), p["wi"].to(dtype),
                           p["wo"].to(dtype), dtype)
    y, drop = _dispatch_combine_local(cfg, x_flat, ids, weights, capacity,
                                      ffn)
    return y.reshape(B, S, D), {"lb_loss": lb, "router_dropped": drop}


# ---------------------------------------------------------------------------
# On a mesh (local shards)
# ---------------------------------------------------------------------------

def _batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.sizes)


def expert_parallel(cfg: ModelConfig, mesh, batch: int) -> bool:
    """Whether `moe_apply` takes the expert-parallel path for a global
    batch of `batch` rows on `mesh` (else the local path over the whole
    batch): the reference's condition, word for word."""
    n_batch = math.prod(mesh.size(a) for a in _batch_axes(mesh))
    return not (batch % n_batch or cfg.n_experts % mesh.size("model")
                or cfg.d_model % mesh.size("data"))


def _weight_specs(cfg: ModelConfig, mesh) -> dict:
    return {k: logical_to_pspec(s.axes, s.shape, mesh)
            for k, s in moe_specs(cfg).items()}


def _moe_mesh_path(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh) -> tuple:
    """The expert-parallel path on this process's shards: x (B_loc, S, D)
    its batch rows (the batch axes' chunk, the sequence whole,
    replicated over ``model``), `p` its shards of the layer's weights.
    Returns y for the same rows, replicated over ``model``.

    Backward: the combine's all-reduce passes the whole gradient to every
    model shard, whose gradient of x and of the router is then its
    experts' part (a partial sum over ``model``, as a tensor-parallel
    block's); each process back-propagates its own term of the averaged
    ``lb_loss``."""
    Bl, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dtype = x.dtype
    axes = _batch_axes(mesh)
    n_batch = math.prod(mesh.size(a) for a in axes)
    n_model = mesh.size("model")
    E_loc = E // n_model
    capacity = _capacity(Bl * S, k, E, cfg.capacity_factor)
    specs = _weight_specs(cfg, mesh)
    grads = mesh.batch + ("model",)
    router = use_weight(p["router"], specs["router"], mesh,
                        grad_partial=grads, dtype=dtype)
    # FSDP: this layer's expert weights gathered over "data" (bf16 wire)
    w = {n: use_weight(p[n], specs[n], mesh, keep=("model",),
                       grad_partial=mesh.batch, dtype=dtype)
         for n in ("wg", "wi", "wo")}
    x_flat = x.reshape(Bl * S, D)
    weights, ids, probs = _route(cfg, router, x_flat)
    lb = _lb_loss(cfg, ids, probs)
    e0 = mesh.index("model") * E_loc
    y, drop = _dispatch_combine_local(
        cfg, x_flat, ids, weights, capacity,
        lambda buf: _expert_ffn(cfg, buf, w["wg"], w["wi"], w["wo"], dtype),
        e0, E_loc)
    y = redistribute(y, (), (), mesh, partial=("model",))  # the EP combine
    # the means over the batch and model shards, in one all-reduce an axis
    stats = redistribute(torch.stack([lb, drop.detach()]), (), (), mesh,
                         partial=axes + ("model",)) / (n_batch * n_model)
    return y.reshape(Bl, S, D), {"lb_loss": stats[0],
                                 "router_dropped": stats[1]}


def _moe_gathered_path(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       mesh) -> tuple:
    """The reference's fallback on a mesh: the local path over the whole
    batch, on every process (its rows and the weights gathered); returns
    this process's rows. Every process computes the same whole gradient,
    so none is summed."""
    specs = _weight_specs(cfg, mesh)
    rows = (mesh.batch or None, None, None)
    whole = {n: use_weight(p[n], specs[n], mesh) for n in p}
    y, aux = _moe_local_path(cfg, whole, redistribute(x, rows, (None,) * 3,
                                                      mesh))
    return redistribute(y, (None,) * 3, rows, mesh), aux


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh=None) -> tuple:
    """x: (B, S, D) -> (y (B, S, D), {"lb_loss", "router_dropped"}).

    Without a mesh, or on a mesh without a ``model`` axis: the local path
    (capacity per batch × expert). On a mesh (`sharding.Mesh.for_batch` of
    the global (B, S)), x and y are this process's batch rows with the
    sequence whole, replicated over ``model``, and `p` its shards of the
    layer's weights: the expert-parallel path where `expert_parallel`
    holds, else the local path over the whole batch."""
    if mesh is None or "model" not in mesh.sizes:
        return _moe_local_path(cfg, p, x)
    batch = x.shape[0] * math.prod(mesh.size(a) for a in mesh.batch)
    if expert_parallel(cfg, mesh, batch):
        return _moe_mesh_path(cfg, p, x, mesh)
    return _moe_gathered_path(cfg, p, x, mesh)
