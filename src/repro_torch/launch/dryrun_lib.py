"""Dry-run machinery: every (arch × shape) cell's memory, its model
FLOPs, and its probed FLOPs, bytes and wire bytes, on one card or as
one device of a mesh (the counterpart of the reference's
`src/repro/launch/dryrun_lib.py`).

The reference lowers and compiles each cell for a 256/512-chip TPU mesh
and reads XLA's memory and cost analyses. The port has no compiler
analysis to read. With no mesh a cell is the whole step on one card:

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

With ``mesh=`` (an abstract mesh, `launch.mesh.make_production_mesh`:
the reference's 16×16 or 2×16×16) a cell is one device of that mesh,
under the rules override it is given:

  - `mesh_memory_stats`: the device's argument bytes, exactly what the
    reference's ``memory_stats(compiled)["argument_bytes"]`` counts: for
    each leaf of the train state (params, AdamW m and v, step: the
    reference's cells take the default optimizer, no compression) and
    the batch, or of the params, the decode cache and the tokens, numel
    ÷ the product of the mesh axes in its PartitionSpec × its element
    size. Arithmetic over 256 or 512 devices, not a measurement of
    them; ``fits`` and ``cards_needed``
    compare it with the card's bytes. As XLA drops the arguments a
    jitted function does not read, a step's unread parameters
    (`Model.unread`: Whisper's decode step) are not counted;
  - the same marginal-layer probes run as one device of the mesh
    (`_probe_mesh`): the train step of `make_train_step(model, tcfg,
    mesh)` on `init_state(..., mesh=mesh)` (local shards drawn at their
    shapes,
    seeded per coordinate) over the global batch, its microbatches
    included, or a prefill or decode on the mesh path, with both
    counters on. It extrapolates the device's FLOPs, bytes and wire
    bytes by kind and by mesh axis (`launch.collectives.COUNTER`) with
    the same weights; ``probe_peak_bytes`` is the card's measured peak
    over the probes (a probe's peak, not the step's). The hand kernels
    run on the local heads and channels; their calls equal their
    launches. The collectives issue nothing: their records are exact,
    the values after them are not the mesh's.

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
from repro_torch.data.pipeline import shard_batch
from repro_torch.device import resolve_device
from repro_torch.kernels.cost import COUNTER, attention_pairs
from repro_torch.launch import collectives as COLL
from repro_torch.launch.mesh import describe
from repro_torch.models.api import get_model
from repro_torch.models.params import (DTYPES, flatten, local_bytes,
                                       local_shape, tree_map, unflatten)
from repro_torch.models.sharding import mesh_axes, rules_ctx
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


def _local_input_bytes(model, shape, mesh) -> int:
    specs, pspecs = model.input_specs(shape), model.input_pspecs(shape, mesh)
    return sum(math.prod(local_shape(t.shape, pspecs[k], mesh))
               * t.element_size() for k, t in specs.items())


def mesh_memory_stats(cfg, shape_name, mesh, hbm_bytes: float) -> dict:
    """One device's argument bytes of a cell on `mesh` (a `Mesh`, or
    {axis: size} for device 0; under the rules in force: call it inside
    `rules_ctx`), by part, with ``fits`` and ``cards_needed`` against
    `hbm_bytes` (module docstring)."""
    shape = _shape(shape_name)
    model = get_model(cfg)
    unread = model.unread(shape.kind)
    specs = {p: s for p, s in flatten(model.specs())
             if not p.startswith(unread)}
    out = {"params_bytes": local_bytes(specs, mesh), "opt_state_bytes": 0,
           "step_bytes": 0, "cache_bytes": 0,
           "input_bytes": _local_input_bytes(model, shape, mesh)}
    if shape.kind == TRAIN:
        state = TL.state_specs(model, OptimizerConfig())
        out["opt_state_bytes"] = local_bytes(state["opt"], mesh)
        out["step_bytes"] = local_bytes({"step": state["step"]}, mesh)
    elif shape.kind == DECODE:
        out["cache_bytes"] = local_bytes(model.cache_specs(
            shape.global_batch, shape.seq_len), mesh)
    out["argument_bytes"] = sum(out.values())
    out["fits"] = out["argument_bytes"] <= hbm_bytes
    out["cards_needed"] = math.ceil(out["argument_bytes"] / hbm_bytes)
    n = math.prod(mesh_axes(mesh).values())
    out["note"] = (f"one device of {n}: arithmetic over the shardings, not "
                   f"a measurement of {n} cards; arguments only (no "
                   f"activations)")
    return out


def mesh_dir(mesh) -> str:
    """The folder of a mesh's cell JSONs: the reference's ``single_pod``
    (16×16) and ``multi_pod`` (2×16×16), else ``mesh_<shape>``."""
    sizes = dict(mesh.sizes)
    if sizes == {"data": 16, "model": 16}:
        return "single_pod"
    if sizes == {"pod": 2, "data": 16, "model": 16}:
        return "multi_pod"
    return "mesh_" + "x".join(str(n) for n in sizes.values())


def describe_mesh(mesh) -> dict:
    return {**describe(mesh), "coords": dict(mesh.coords),
            "abstract": mesh.is_abstract,
            "strides": {a: mesh.stride(a) for a in mesh.names}}


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
    """Σ weight × cost over (weight, cost) pairs, key by key (nested dicts
    key by key at every level)."""
    out: dict = {}

    def add(into, cost, w):
        for k, v in cost.items():
            if isinstance(v, dict):
                add(into.setdefault(k, {}), v, w)
            else:
                into[k] = into.get(k, 0) + w * v
    for w, c in parts:
        add(out, c, w)
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


def _local_cache(model, batch: int, max_seq: int, mesh):
    """One device's zero decode cache on `mesh` at its shard shapes, at
    the last position (``pos`` = max_seq − 1, ``max_seq`` carried as
    the mesh path's caches carry it)."""
    specs = model.cache_specs(batch, max_seq)
    pspecs = dict(flatten(model.cache_pspecs(batch, max_seq, mesh)))
    leaves = {}
    for path, spec in flatten(specs):
        if path != "pos":
            leaves[path] = torch.zeros(
                local_shape(spec.shape, pspecs[path], mesh),
                dtype=DTYPES[spec.dtype], device=mesh.device)
    leaves["pos"] = max_seq - 1
    cache = unflatten(specs, leaves)
    cache["max_seq"] = max_seq
    return cache


def _probe_mesh_once(cfg, shape, mesh, remat, microbatch, count_flops,
                     seed=0) -> dict:
    """One probe at `cfg`'s depth as one device of `mesh`: the whole
    step (train: every microbatch and the update) on the global batch,
    counted (FLOPs and bytes with `count_flops`; the collectives always)."""
    model = get_model(cfg)
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == TRAIN:
        tcfg = TrainConfig(seq_len=S, global_batch=B, remat=remat,
                           microbatch=microbatch, optimizer=OptimizerConfig())
        state = TL.init_state(model, tcfg.optimizer, seed, mesh=mesh)
        fn = TL.make_train_step(model, tcfg, mesh)
        args = (state, _batch(cfg, shape, B, dev, gen))
    else:
        run = mesh.for_batch((B, S))
        params = model.prepare(model.init_local(run, seed))
        if shape.kind == PREFILL:
            batch = shard_batch(_batch(cfg, shape, B, dev, gen), run)
            fn = lambda p, b: model.prefill(p, b, mesh=run)  # noqa: E731
            args = (params, batch)
        else:
            tok = shard_batch({"tokens": _batch(cfg, shape, B, dev, gen)[
                "tokens"][:, 0]}, run)["tokens"]
            fn = lambda p, c, t: model.decode(p, c, t, mesh=run)  # noqa: E731
            args = (params, _local_cache(model, B, S, run), tok)
    COLL.COUNTER.reset()
    with COLL.COUNTER.on():
        if count_flops:
            out = count_cost(fn, *args)
        else:
            calls0 = dict(COUNTER.calls)
            with COUNTER.on():
                fn(*args)
            out = {"kernel_calls": {k: v - calls0[k]
                                    for k, v in COUNTER.calls.items()}}
    out["collectives"] = COLL.COUNTER.summary()
    COLL.COUNTER.reset()
    return out


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
    return memory_stats(_deepest(cfg), shape_name, hbm_bytes,
                        batch=unit)["peak_bytes"] <= hbm_bytes


def _deepest(cfg):
    return max((c for _, c in _probe_depths(cfg)),
               key=lambda c: get_model(c).param_count())


def _probe_mesh(cfg, shape, mesh, remat, microbatch, hbm,
                count_flops) -> Optional[dict]:
    """`probe_cost` as one device of `mesh`: every probe's whole step,
    weighed; None when the deepest probe's per-device arguments do not
    fit the card."""
    if not mesh_memory_stats(_deepest(cfg), shape, mesh, hbm)["fits"]:
        return None
    cuda = mesh.device.type == "cuda"
    parts, peak = [], None
    for w, pcfg in _probe_depths(cfg):
        if w == 0:
            continue
        if cuda:
            torch.cuda.reset_peak_memory_stats(mesh.device)
        parts.append((w, _probe_mesh_once(pcfg, shape, mesh, remat,
                                          microbatch, count_flops)))
        if cuda:
            torch.cuda.synchronize(mesh.device)
            peak = max(peak or 0, torch.cuda.max_memory_allocated(
                mesh.device))
            torch.cuda.empty_cache()
    out = _combine(parts)
    for a, row in out["collectives"]["per_axis"].items():
        row.update(n=mesh.size(a), stride=mesh.stride(a))
    out["probe_peak_bytes"] = peak
    return out


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
                 probes: bool = True, save_dir: Optional[str] = None,
                 mesh=None, rules_override: Optional[dict] = None) -> dict:
    """One cell's record (JSON under `save_dir`). With `mesh` (abstract)
    the cell is one device of it, built and run under
    ``rules_ctx(rules_override)``: its argument bytes, its wire bytes
    from the probes always, and with `probes` its FLOPs and bytes."""
    spec = get_arch(arch_id)
    where = "single_card" if mesh is None else mesh_dir(mesh)
    if shape_name in spec.skip_shapes:
        result = {"arch": arch_id, "shape": shape_name,
                  "status": "skipped", "reason": spec.skip_shapes[shape_name]}
        if save_dir:
            _save(save_dir, arch_id, shape_name, result, where)
        return result
    cfg = cfg if cfg is not None else spec.full
    if mesh is not None:
        with rules_ctx(rules_override):
            result = _analyze_on_mesh(arch_id, shape_name, cfg, mesh, remat,
                                      microbatch, probes)
        if save_dir:
            _save(save_dir, arch_id, shape_name, result, where)
        return result
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


def _analyze_on_mesh(arch_id, shape_name, cfg, mesh, remat, microbatch,
                     probes) -> dict:
    hw = hardware(mesh.device)
    shape = _shape(shape_name)
    model = get_model(cfg)
    mem = mesh_memory_stats(cfg, shape, mesh, hw["hbm_bytes"])
    result = {"arch": arch_id, "shape": shape.name, "kind": shape.kind,
              "device": str(mesh.device), "devices": mesh.n_devices,
              "mesh": describe_mesh(mesh), "remat": remat,
              "microbatch": microbatch, "params": model.param_count(),
              "status": "ok", "card": hw["card"],
              "card_bytes": hw["hbm_bytes"], "memory": mem,
              "model_flops_global": model_flops(arch_id, shape, cfg)}
    if not mem["fits"]:
        result["probe"] = ("does not fit one card: the per-device "
                           "arguments exceed it")
        return result
    probed = _probe_mesh(cfg, shape, mesh, remat, microbatch,
                         hw["hbm_bytes"], probes)
    if probed is None:
        result["probe"] = ("does not fit one card: the deepest probe's "
                           "per-device arguments exceed it")
        return result
    result["collectives"] = probed.pop("collectives")
    mem["probe_peak_bytes"] = probed.pop("probe_peak_bytes")
    result["kernel_calls"] = probed.pop("kernel_calls")
    if probes:
        result["cost_probed"] = probed
    return result


def cell_path(save_dir: str, arch_id: str, shape_name: str,
              where: str = "single_card") -> str:
    """A cell's JSON: ``where`` is ``single_card``, or a mesh's folder
    (`mesh_dir`: ``single_pod``, ``multi_pod``)."""
    return os.path.join(save_dir, where, f"{arch_id}__{shape_name}.json")


def _save(save_dir: str, arch_id: str, shape_name: str, result: dict,
          where: str = "single_card"):
    path = cell_path(save_dir, arch_id, shape_name, where)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
