"""Training loop: state construction, the train step with gradient
accumulation, and a simple training loop `run` (the reference's
`src/repro/train/loop.py`).

State = ``{"params", "opt": {"m", "v"}, "step" [, "ef"]}``, nested dicts
of tensors on one device: float32 master parameters (cast to the
activation dtype inside the loss, as the reference casts with
``cast_weights``), float32 optimizer moments, an int32 step and, with
compression, float32 error feedback. `make_train_step` builds the
function the carbon-aware trainer drives: microbatches run one after
another in a Python loop (the reference's ``lax.scan``), each backward
adding its float32 gradients into the masters' ``.grad`` (the sum of
the reference's scan), which are then divided by their count; then
compression, then the optimizer update. The step spends the state it
is given, as the reference jits its step with the state donated: AdamW
writes the new parameters and moments into it, which a model whose
AdamW state fills most of the card needs. A caller that keeps the old
state clones it first.

On a mesh (``mesh=``, a `sharding.Mesh`) the state is placed like the
parameters (`state_pspecs`: m, v and ef share each parameter's spec, the
step is replicated), each process holding its shards; the step takes
the *global* batch, slices the microbatches from it as on one device
and gives each process its ('batch', 'seq') slice of each microbatch
(`data.pipeline.shard_batch`; where the batch axes do not divide the
microbatch the rules drop them). The loss runs on local shards
(`Model.loss(mesh=)`), the gradients come back as local shards, and
the optimizer's whole-tree statistics are taken over the mesh. The
reported loss is the global one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.config import OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import shard_batch, to_device
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.models.params import (DTYPES, ParamSpec, flatten,
                                      param_pspecs, param_shardings,
                                      shard_tree, tree_map)
from repro_torch.models.sharding import all_reduce
from repro_torch.spans import span
from repro_torch.train import compression as COMP
from repro_torch.train import optimizer as OPT


# ---------------------------------------------------------------------------
# State specs / construction
# ---------------------------------------------------------------------------

def state_specs(model: Model, opt_cfg: OptimizerConfig) -> dict:
    pspecs = model.specs()
    f32 = lambda s: dataclasses.replace(s, dtype="float32", init="zeros")  # noqa: E731
    out = {
        "params": pspecs,
        "opt": {"m": tree_map(f32, pspecs), "v": tree_map(f32, pspecs)},
        "step": ParamSpec((), (), init="zeros", dtype="int32"),
    }
    if opt_cfg.compression != "none":
        out["ef"] = tree_map(f32, pspecs)
    return out


def abstract_state(model: Model, opt_cfg: OptimizerConfig) -> dict:
    """The state's shapes and dtypes as tensors on the meta device (what
    `checkpoint.load` restores into)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=DTYPES[s.dtype],
                                          device="meta"),
                    state_specs(model, opt_cfg))


def state_pspecs(model: Model, opt_cfg: OptimizerConfig, mesh,
                 overrides=None) -> dict:
    return param_pspecs(state_specs(model, opt_cfg), mesh, overrides)


def state_shardings(model: Model, opt_cfg: OptimizerConfig, mesh) -> dict:
    return param_shardings(state_specs(model, opt_cfg), mesh)


def init_state(model: Model, opt_cfg: OptimizerConfig, seed=0,
               device="cuda", mesh=None) -> dict:
    """A fresh state on `device`; `seed` an int or a torch.Generator. On
    a mesh, the same state placed onto it: the full parameters are drawn
    on the mesh's device and each process keeps its shard of them, its
    zero moments (and error feedback) made at the shard's shape. On an
    abstract mesh the shards are drawn directly (`Model.init_local`):
    one device's share of a model that no card holds whole."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    if mesh is not None and mesh.is_abstract:
        params = model.init_local(mesh, seed)
    else:
        params = model.init(seed, device=dev)
    if mesh is not None and not mesh.is_abstract:
        params = shard_tree(params, model.shardings(mesh))
    state = {"params": params, "opt": OPT.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if opt_cfg.compression != "none":
        state["ef"] = COMP.ef_init(params)
    return state


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _backward(model: Model, remat: str, leaves: dict, batch: dict,
              mesh=None):
    """(loss, metrics) of the model's loss at `leaves` (tensors requiring
    grad), its gradients added into the leaves' ``.grad``. On a mesh the
    loss is summed over the processes that hold distinct batch rows."""
    with torch.enable_grad():
        with span("train.forward"):
            loss, metrics = model.loss(leaves, batch, remat=remat, mesh=mesh)
        with span("train.backward"):
            loss.backward()
    loss = loss.detach()
    for a in mesh.batch if mesh is not None else ():
        loss = all_reduce(loss, mesh, a)
    return loss, {k: v.detach() for k, v in metrics.items()}


def _grad_leaves(params: dict) -> dict:
    return tree_map(lambda t: t.detach().requires_grad_(), params)


def _grads(leaves: dict) -> dict:
    """The leaves' ``.grad`` as a tree; every leaf must have one."""
    for path, t in flatten(leaves):
        if t.grad is None:
            raise RuntimeError(f"no gradient reached the parameter {path}")
    return tree_map(lambda t: t.grad, leaves)


def _value_and_grad(model: Model, remat: str, params: dict, batch: dict):
    """((loss, metrics), grads) of the model's loss at `params`; the
    gradients have the parameters' dtypes."""
    leaves = _grad_leaves(params)
    out = _backward(model, remat, leaves, batch)
    return out, _grads(leaves)


def make_train_step(model: Model, cfg: TrainConfig, mesh=None) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``; `batch` holds
    tensors on the state's device (an encoder-decoder's ``frames`` are
    split into microbatches like the tokens), or on a mesh the global
    host batch. metrics: loss, the model's metrics (of the last
    microbatch), grad_norm and lr, as 0-d tensors. The state passed in
    is spent: the new state holds its tensors."""
    opt_cfg = cfg.optimizer
    update = OPT.UPDATES[opt_cfg.name]
    micro = (cfg.microbatch if cfg.microbatch
             and cfg.microbatch < cfg.global_batch else cfg.global_batch)
    n_micro = cfg.global_batch // micro
    shardings = None
    if mesh is not None:
        mesh = mesh.for_batch((micro, cfg.seq_len))
        shardings = model.shardings(mesh)

    def sum_grads(params, batch):
        """((loss summed over the microbatches, the last one's metrics),
        gradients summed over the microbatches)."""
        if n_micro == 1 and mesh is None:
            return _value_and_grad(model, cfg.remat, params, batch)
        leaves = _grad_leaves(params)
        lsum = None
        for i in range(n_micro):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            if mesh is not None:
                mb = shard_batch(mb, mesh)
            loss, metrics = _backward(model, cfg.remat, leaves, mb, mesh)
            lsum = loss if lsum is None else lsum + loss
        return (lsum, metrics), _grads(leaves)

    def train_step(state: dict, batch: dict):
        (loss, metrics), grads = sum_grads(state["params"], batch)
        with span("train.optimizer"):
            if n_micro > 1:
                divisor = torch.tensor(float(n_micro), device=loss.device)
                grads = tree_map(lambda t: t.float().div_(divisor), grads)
                loss = loss / divisor
            new_state = dict(state)
            on_mesh = {} if shardings is None else {"shardings": shardings}
            if opt_cfg.compression == "int8":
                grads, new_state["ef"] = COMP.compress_int8(
                    grads, state["ef"], **on_mesh)
            elif opt_cfg.compression == "topk":
                grads, new_state["ef"] = COMP.compress_topk(
                    grads, state["ef"], opt_cfg.topk_ratio, **on_mesh)
            new_p, new_opt, opt_metrics = update(
                opt_cfg, grads, state["opt"], state["params"], state["step"],
                **on_mesh)
            new_state.update({"params": new_p, "opt": new_opt,
                              "step": state["step"] + 1})
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


# ---------------------------------------------------------------------------
# Simple loop (single-process; the carbon-aware trainer wraps the step)
# ---------------------------------------------------------------------------

def run(model: Model, cfg: TrainConfig, data_iter, *, device="cuda",
        mesh=None, state: Optional[dict] = None,
        step_callback: Optional[Callable] = None) -> dict:
    """Train for cfg.steps; returns {"state", "history"}. Each step is
    timed to a device sync (`step_time_s`) and spends the state (a
    `state` passed in is spent); step_callback gets (i, state,
    metrics). On a mesh every process runs this with the same data."""
    dev = resolve_device(device) if mesh is None else mesh.device
    if state is None:
        state = init_state(model, cfg.optimizer, cfg.seed, dev, mesh)
    step_fn = make_train_step(model, cfg, mesh)
    history = []
    it = iter(data_iter)
    for i in range(cfg.steps):
        batch = next(it) if mesh is not None else to_device(next(it), dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # syncs
        dt = time.perf_counter() - t0
        metrics["step_time_s"] = dt
        metrics["tokens"] = cfg.global_batch * cfg.seq_len
        history.append(metrics)
        if step_callback is not None:
            step_callback(i, state, metrics)
        if cfg.log_every and i % cfg.log_every == 0:
            print(f"step {i:5d} loss {metrics['loss']:.4f} "
                  f"({dt*1e3:.0f} ms)", flush=True)
    return {"state": state, "history": history}
