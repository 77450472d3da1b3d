"""Dry-run machinery on one card: every (arch × shape) cell's memory,
its model FLOPs, and its probed FLOPs and bytes (the single-card
counterpart of the reference's `src/repro/launch/dryrun_lib.py`).

The reference lowers and compiles each cell for a 256/512-chip TPU mesh
and reads XLA's memory and cost analyses. One card has no mesh to prove
and no compiler analysis to read, so a cell here is:

  - `memory_stats`: the bytes of the cell's arguments from the abstract
    trees (meta tensors, nothing allocated): the float32 parameters, for
    train the AdamW moments and the float32 gradients, for prefill and
    decode the KV or state cache, and the inputs; with ``cards_needed``
    = ⌈peak / the card's bytes⌉. Activations are not counted, so the
    peak is a lower bound;
  - `model_flops`: the reference's 6·N_active·D (train) or 2·N_active·D;
  - `probe_cost`: the reference's marginal-layer probes (1 → 2 layers;
    hybrid one pattern, two patterns and the trailing blocks; encdec
    (1, 1), (2, 1), (1, 2)), each one real call of the cell's function
    at the published widths on one sequence (one microbatch for train),
    scaled by the batch. FLOPs are what
    ``torch.utils.flop_counter.FlopCounterMode`` counts for the aten ops
    plus the hand kernels' work from `kernels.cost.COUNTER` (the kernels
    launch outside aten, where FlopCounterMode cannot see them); bytes
    are each aten op's inputs and outputs (views and allocations move
    none) plus the kernels' bytes. Inside a counted kernel call the
    plain version's aten ops are left out, so the kernel's formula
    stands in for them on either route. A train probe counts one
    microbatch's loss and backward (× the microbatches of the step) and
    one AdamW update. A probe whose parameters and state do not fit the
    card is skipped and says so.

`HW` holds the H100 SXM data-sheet peaks; `hardware(device)` adds the
card's bytes, read at run time (80e9 where no card is present).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import (DECODE, ENCDEC, HYBRID, MOE, PREFILL, SHAPES,
                                TRAIN, OptimizerConfig, TrainConfig)
from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.kernels.cost import COUNTER, attention_pairs
from repro_torch.models.api import get_model
from repro_torch.models.params import DTYPES, flatten, tree_map
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as OPT

# NVIDIA H100 SXM, data sheet, dense rates at the full 700 W power limit
HW = {"peak_flops_bf16": 989e12, "peak_flops_fp32": 67e12,
      "hbm_bw": 3.35e12, "hbm_bytes": 80e9}


def hardware(device="cuda") -> dict:
    """`HW` with ``hbm_bytes`` the card's memory (80e9 without a card)
    and ``card`` its name."""
    dev = resolve_device(device)
    out = dict(HW, card="none (no card: data-sheet memory)")
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        out.update(hbm_bytes=float(props.total_memory), card=props.name)
    return out


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

def _shape(shape):
    """A `ShapeConfig`, given one or its name in `SHAPES`."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def build_cell(arch_id: str, shape_name: str, device="cuda", *, cfg=None,
               remat: str = "full", microbatch: int = 0):
    """Returns (fn, abstract_args, meta): the cell's function (a train
    step, a prefill or a decode step), its arguments as meta tensors,
    and what the cell is."""
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else get_arch(arch_id).full
    shape = _shape(shape_name)
    model = get_model(cfg)
    inputs = model.input_specs(shape)
    if shape.kind == TRAIN:
        tcfg = TrainConfig(seq_len=shape.seq_len,
                           global_batch=shape.global_batch, remat=remat,
                           microbatch=microbatch, optimizer=OptimizerConfig())
        fn = TL.make_train_step(model, tcfg)
        args = (TL.abstract_state(model, tcfg.optimizer), inputs)
    elif shape.kind == PREFILL:
        fn = model.prefill
        args = (model.abstract(), inputs)
    elif shape.kind == DECODE:
        fn = model.decode
        args = (model.abstract(), model.abstract_cache(shape.global_batch,
                                                       shape.seq_len),
                inputs["tokens"])
    else:
        raise ValueError(shape.kind)
    meta = {"arch": arch_id, "shape": shape_name, "kind": shape.kind,
            "device": str(dev), "devices": 1, "remat": remat,
            "microbatch": microbatch, "params": model.param_count()}
    return fn, args, meta


def memory_stats(cfg, shape_name: str, hbm_bytes: float,
                 batch: Optional[int] = None) -> dict:
    """The bytes of one cell's arguments (at `batch` sequences, default
    the shape's) from the abstract trees; train adds the float32
    gradients. ``cards_needed`` = ⌈peak / hbm_bytes⌉."""
    shape = _shape(shape_name)
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    model = get_model(cfg)
    params = _nbytes(model.abstract())
    out = {"params_bytes": params, "opt_state_bytes": 0, "grad_bytes": 0,
           "cache_bytes": 0,
           "input_bytes": _nbytes(model.input_specs(shape))}
    if shape.kind == TRAIN:
        state = TL.abstract_state(model, OptimizerConfig())
        out["opt_state_bytes"] = _nbytes(state["opt"])
        out["grad_bytes"] = params
    else:
        out["cache_bytes"] = _nbytes(model.abstract_cache(
            shape.global_batch, shape.seq_len))
    out["peak_bytes"] = sum(out.values())
    out["cards_needed"] = math.ceil(out["peak_bytes"] / hbm_bytes)
    out["note"] = "arguments only (no activations): a lower bound"
    return out


# ---------------------------------------------------------------------------
# Counting probes
# ---------------------------------------------------------------------------

# aten ops that allocate or alias without moving data
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "detach", "alias", "lift_fresh",
            "_local_scalar_dense"}


def _moves_data(func) -> bool:
    if func.overloadpacket.__name__ in _NO_DATA:
        return False
    return not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)


class _AtenBytes(TorchDispatchMode):
    """Sums each aten op's input and output bytes, outside counted
    kernel calls."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if COUNTER.depth == 0 and _moves_data(func):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def count_cost(fn, *args) -> dict:
    """Run ``fn(*args)`` once and count its FLOPs and bytes: the aten
    ops' (FlopCounterMode; `_AtenBytes`) outside counted kernel calls
    plus the kernels' (`kernels.cost.COUNTER`)."""
    flop_mode, byte_mode = FlopCounterMode(display=False), _AtenBytes()
    calls0, flops0, bytes0 = (dict(COUNTER.calls), sum(COUNTER.flops.values()),
                              sum(COUNTER.bytes.values()))
    excluded0 = COUNTER.excluded_flops
    COUNTER.aten_flops = flop_mode.get_total_flops
    try:
        with COUNTER.on(), flop_mode, byte_mode:
            fn(*args)
    finally:
        COUNTER.aten_flops = None
    aten_flops = (flop_mode.get_total_flops()
                  - (COUNTER.excluded_flops - excluded0))
    kernel_flops = sum(COUNTER.flops.values()) - flops0
    kernel_bytes = sum(COUNTER.bytes.values()) - bytes0
    return {"flops": aten_flops + kernel_flops,
            "bytes_accessed": byte_mode.bytes + kernel_bytes,
            "aten_flops": aten_flops, "aten_bytes": byte_mode.bytes,
            "kernel_flops": kernel_flops, "kernel_bytes": kernel_bytes,
            "kernel_calls": {k: v - calls0[k] for k, v in
                             COUNTER.calls.items()}}


def _combine(parts) -> dict:
    """Σ weight × cost over (weight, cost) pairs, key by key."""
    out = {}
    for w, c in parts:
        for k, v in c.items():
            if isinstance(v, dict):
                sub = out.setdefault(k, {})
                for kk, vv in v.items():
                    sub[kk] = sub.get(kk, 0) + w * vv
            else:
                out[k] = out.get(k, 0) + w * v
    return out


def _batch(cfg, shape, n, dev, gen):
    """Seeded inputs of `n` sequences of the shape (int64 tokens; an
    encoder-decoder's frames in the activation dtype)."""
    S = 1 if shape.kind == DECODE else shape.seq_len
    tok = lambda: torch.randint(0, cfg.vocab_size, (n, S), generator=gen,  # noqa: E731
                                device=dev)
    out = {"tokens": tok()}
    if shape.kind == TRAIN:
        out["labels"] = tok()
    if cfg.family == ENCDEC and shape.kind != DECODE:
        out["frames"] = torch.randn(n, cfg.enc_seq, cfg.d_model,
                                    generator=gen, device=dev).to(
                                        DTYPES[cfg.dtype])
    return out


def _probe_once(cfg, shape, dev, remat, unit, seed=0) -> dict:
    """The counted cost of one probe call at `cfg`'s depth on `unit`
    sequences; for train {"grads": ..., "update": ...}."""
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = _batch(cfg, shape, unit, dev, gen)
    if shape.kind == TRAIN:
        opt_cfg = OptimizerConfig()
        state = TL.init_state(model, opt_cfg, seed, dev)
        grads_cost = count_cost(TL._value_and_grad, model, remat,
                                state["params"], batch)
        grads = tree_map(torch.zeros_like, state["params"])
        update = OPT.UPDATES[opt_cfg.name]
        update_cost = count_cost(update, opt_cfg, grads, state["opt"],
                                 state["params"], state["step"])
        return {"grads": grads_cost, "update": update_cost}
    params = model.prepare(model.init(seed, device=dev))
    if shape.kind == PREFILL:
        return count_cost(model.prefill, params, batch)
    cache = model.init_cache(unit, shape.seq_len, device=dev)
    cache["pos"] = shape.seq_len - 1       # the step at the last position
    return count_cost(model.decode, params, cache, batch["tokens"][:, 0])


def _probe_depths(cfg) -> list:
    """(weight, config) pairs whose weighted sum of probe costs is the
    full depth's cost: the reference's marginal-layer extrapolation."""
    at = lambda **kw: dataclasses.replace(cfg, **kw)  # noqa: E731
    if cfg.family == HYBRID:
        pat = len(cfg.block_pattern)
        n_super = cfg.n_layers // pat
        n_trail = cfg.n_layers - n_super * pat
        f3, f6 = at(n_layers=pat), at(n_layers=2 * pat)
        out = [(1 - (n_super - 1), f3), (n_super - 1, f6)]
        if n_trail:
            out = [(out[0][0] - 1, f3), out[1], (1, at(n_layers=pat + n_trail))]
        return out
    if cfg.family == ENCDEC:
        L, E = cfg.n_layers, cfg.n_enc_layers
        return [(1 - (L - 1) - (E - 1), at(n_layers=1, n_enc_layers=1)),
                (L - 1, at(n_layers=2, n_enc_layers=1)),
                (E - 1, at(n_layers=1, n_enc_layers=2))]
    L = cfg.n_layers
    return [(1 - (L - 1), at(n_layers=1)), (L - 1, at(n_layers=2))]


def _fits(cfg, shape_name, unit, hbm_bytes) -> bool:
    """Whether the deepest probe's parameters and state (no
    activations) fit the card."""
    deepest = max((c for _, c in _probe_depths(cfg)),
                  key=lambda c: get_model(c).param_count())
    return memory_stats(deepest, shape_name, hbm_bytes,
                        batch=unit)["peak_bytes"] <= hbm_bytes


def probe_cost(arch_id: str, shape_name: str, device="cuda", *,
               cfg=None, remat: str = "full", microbatch: int = 0,
               hbm_bytes: Optional[float] = None) -> Optional[dict]:
    """The full-depth cost of one step of the cell from the marginal-
    layer probes, scaled by the batch; None when a probe does not fit
    the card."""
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else get_arch(arch_id).full
    shape = _shape(shape_name)
    unit = microbatch if (shape.kind == TRAIN and microbatch) else 1
    scale = shape.global_batch // unit
    hbm = hbm_bytes if hbm_bytes is not None else hardware(dev)["hbm_bytes"]
    if not _fits(cfg, shape, unit, hbm):
        return None
    parts = []
    for w, pcfg in _probe_depths(cfg):
        if w == 0:
            continue
        c = _probe_once(pcfg, shape, dev, remat, unit)
        if shape.kind == TRAIN:
            c = _combine([(scale, c["grads"]), (1, c["update"])])
        else:
            c = _combine([(scale, c)])
        parts.append((w, c))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
    out = _combine(parts)
    out["probe_sequences"] = unit
    out["batch_scale"] = scale
    return out


# ---------------------------------------------------------------------------
# Analytic model FLOPs
# ---------------------------------------------------------------------------

def model_flops(arch_id: str, shape_name: str, cfg=None) -> float:
    """Global MODEL_FLOPS: 6·N_active·D for train, 2·N_active·D otherwise."""
    cfg = cfg if cfg is not None else get_arch(arch_id).full
    shape = _shape(shape_name)
    mult = 6.0 if shape.kind == TRAIN else 2.0
    return mult * cfg.active_param_count() * shape.tokens_per_step


def train_model_flops(model, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 × parameters × the tokens each
    parameter sees (the encoder's the frames, the rest the decoder
    tokens; the MoE family counts the parameters active per token, the
    top_k of n_experts), plus 3 × the forward's token-mixing products:
    the SSD's chunked products, local and full attention's score and
    value products over the (q, key) pairs each keeps."""
    cfg = model.cfg
    n = {p: math.prod(s.shape) for p, s in flatten(model.specs())}
    total = sum(n.values())
    if cfg.family == MOE:
        total -= cfg.param_count() - cfg.active_param_count()
    if cfg.family == ENCDEC:
        enc = sum(v for p, v in n.items() if p.startswith(("enc_layers",
                                                           "enc_norm")))
        frames = batch * cfg.enc_seq
        flops = 6.0 * (enc * frames + (total - enc) * batch * seq)
        dh = cfg.n_heads * cfg.head_dim
        mix = 4 * batch * dh * (cfg.n_enc_layers * cfg.enc_seq ** 2
                                + cfg.n_layers * (attention_pairs(
                                    seq, seq, True, 0) + seq * cfg.enc_seq))
        return flops + 3 * mix
    flops = 6.0 * total * batch * seq
    if cfg.family == "ssm":
        Q, H, P, N = (cfg.ssm_chunk, cfg.ssm_n_heads, cfg.ssm_head_dim,
                      cfg.ssm_state)
        mix = cfg.n_layers * batch * (seq // Q) * (
            2 * Q * Q * N + H * (2 * Q * Q * P + 4 * Q * P * N))
    else:
        hybrid = cfg.family == HYBRID
        mix = (cfg.n_layers // 3 if hybrid else cfg.n_layers) * (
            4 * batch * cfg.n_heads * cfg.head_dim
            * attention_pairs(seq, seq, True,
                              cfg.local_window if hybrid else 0))
    return flops + 3 * mix


# ---------------------------------------------------------------------------
# Full cell analysis -> JSON
# ---------------------------------------------------------------------------

def analyze_cell(arch_id: str, shape_name: str, device="cuda", *,
                 cfg=None, remat: str = "full", microbatch: int = 0,
                 probes: bool = True, save_dir: Optional[str] = None) -> dict:
    spec = get_arch(arch_id)
    if shape_name in spec.skip_shapes:
        result = {"arch": arch_id, "shape": shape_name,
                  "status": "skipped", "reason": spec.skip_shapes[shape_name]}
        if save_dir:
            _save(save_dir, arch_id, shape_name, result)
        return result
    cfg = cfg if cfg is not None else spec.full
    hw = hardware(device)
    _, _, meta = build_cell(arch_id, shape_name, device, cfg=cfg,
                            remat=remat, microbatch=microbatch)
    shape = _shape(shape_name)
    result = {**meta, "status": "ok", "card": hw["card"],
              "card_bytes": hw["hbm_bytes"],
              "memory": memory_stats(cfg, shape_name, hw["hbm_bytes"]),
              "model_flops_global": model_flops(arch_id, shape_name, cfg)}
    if shape.kind == TRAIN:
        result["train_model_flops"] = train_model_flops(
            get_model(cfg), shape.global_batch, shape.seq_len)
    if probes:
        probed = probe_cost(arch_id, shape_name, device, cfg=cfg,
                            remat=remat, microbatch=microbatch,
                            hbm_bytes=hw["hbm_bytes"])
        if probed is None:
            result["probe"] = "does not fit one card (parameters and state)"
        else:
            result["cost_probed"] = probed
    if save_dir:
        _save(save_dir, arch_id, shape_name, result)
    return result


def cell_path(save_dir: str, arch_id: str, shape_name: str) -> str:
    return os.path.join(save_dir, "single_card",
                        f"{arch_id}__{shape_name}.json")


def _save(save_dir: str, arch_id: str, shape_name: str, result: dict):
    path = cell_path(save_dir, arch_id, shape_name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
