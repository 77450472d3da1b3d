"""AdamW, SGD with momentum and the learning-rate schedules (the
reference's `src/repro/train/optimizer.py`).

Optimizer state mirrors the parameter tree: ``{"m": tree, "v": tree}``
of float32 tensors. All master math is float32 in the reference's
expression order (``b1 ** t`` a float32 power, ``mhat / (sqrt(vhat) +
eps) + wd·p``), so the CPU agrees with it to float32 rounding.
`torch.optim.AdamW` is no substitute: it decays the weights apart from
the Adam step. An update spends the trees it is given, as the reference
jits its train step with the state donated: AdamW writes the new values
into the parameters, the moments and the gradients, in slices of at
most `SLICE` entries, so a model whose state fills most of the card
still takes its step; SGD returns new trees.

On a mesh the trees hold local shards and ``shardings`` (a tree of
`NamedSharding`s, the parameters') is given: every statistic taken over
a whole leaf or the whole tree, the global norm and so the clip scale,
is then the whole tree's (`sharding.whole_leaf_stats`), equal on every
process, so replicas of a leaf take the same step.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.models.params import flatten, tree_map, unflatten
from repro_torch.models.sharding import whole_leaf_stats

F32 = torch.float32
SLICE = 1 << 24         # entries an AdamW update works on at a time


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=like.device)


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a 0-d tensor), a float32 0-d tensor."""
    step = step.to(F32)
    if cfg.warmup_steps > 0:
        warm = torch.minimum(step / cfg.warmup_steps, _f32(1.0, step))
    else:
        warm = 1.0
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    elif cfg.schedule == "constant":
        decay = 1.0
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * (decay if isinstance(decay, torch.Tensor)
                            else _f32(decay, step))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: dict) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of sum(x²), float32;
    on a mesh, of the whole leaves."""
    leaves = [torch.sum(torch.square(x.to(F32))) for _, x in flatten(tree)]
    if shardings is not None:
        leaves = whole_leaf_stats(leaves, [s for _, s in flatten(shardings)],
                                  "sum")
    total = leaves[0]
    for x in leaves[1:]:
        total = total + x
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # an IEEE quotient: `float / tensor` is a reciprocal times the float
    return torch.clamp(torch.div(_f32(max_norm, norm),
                                 torch.clamp(norm, min=1e-9)), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float,
                        shardings=None) -> tuple:
    norm = global_norm(grads, shardings)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(F32) * scale, grads), norm


def _zip(fn, params, *trees):
    """unflatten(params, fn(p, *others) per leaf), leaves by path."""
    flat = [dict(flatten(t)) for t in trees]
    return {path: fn(p, *(f[path] for f in flat))
            for path, p in flatten(params)}


def _slices(*leaves):
    """The leaves (one shape) as views along dim 0, each of at most
    `SLICE` entries where rows allow (an elementwise update of the views
    is one of the leaves)."""
    t = leaves[0]
    if t.dim() == 0 or t.numel() <= SLICE:
        return [leaves]
    rows = max(1, SLICE // (t.numel() // t.shape[0]))
    return zip(*(x.split(rows, 0) for x in leaves))


def _adamw_(cfg: OptimizerConfig, lr, bc1, bc2, p, g, m, v):
    """One AdamW step in place: p, m and v take their new values and g is
    spent. Each operation is the reference's, in its order:
    m = b1·m + (1 - b1)·g; v = b2·v + (1 - b2)·g²; p -= lr·(m/bc1 /
    (sqrt(v/bc2) + eps) + wd·p)."""
    v.mul_(cfg.b2).add_(torch.square(g).mul_(1.0 - cfg.b2))
    m.mul_(cfg.b1).add_(g.mul_(1.0 - cfg.b1))
    den = (v / bc2).sqrt_().add_(cfg.eps)
    delta = (m / bc1).div_(den).add_(cfg.weight_decay * p.to(F32))
    p.sub_(delta.mul_(lr))


def adamw_update(cfg: OptimizerConfig, grads, opt_state, params, step,
                 shardings=None):
    """Returns (new_params, new_opt_state, metrics). All f32 master math.
    The new values are written into `params`, ``opt_state``'s moments and
    `grads` (all spent), which are returned."""
    grads = tree_map(lambda g: g.to(F32), grads)
    gnorm = global_norm(grads, shardings)
    if cfg.grad_clip > 0:
        scale = _clip_scale(gnorm, cfg.grad_clip)
        for _, g in flatten(grads):
            g.mul_(scale)
    lr = lr_at(cfg, step)
    t = step.to(F32) + 1.0
    bc1 = 1.0 - torch.pow(_f32(cfg.b1, t), t)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2, t), t)
    flat = [dict(flatten(tree)) for tree in (grads, opt_state["m"],
                                             opt_state["v"])]
    for path, p in flatten(params):
        for views in _slices(p, *(f[path] for f in flat)):
            _adamw_(cfg, lr, bc1, bc2, *views)
    return params, {"m": opt_state["m"], "v": opt_state["v"]}, {
        "grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# SGD (baseline optimizer)
# ---------------------------------------------------------------------------

def sgd_update(cfg: OptimizerConfig, grads, opt_state, params, step,
               shardings=None):
    lr = lr_at(cfg, step)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, shardings)
    else:
        gnorm = global_norm(grads, shardings)
    mom = unflatten(params, _zip(lambda p, m, g: 0.9 * m + g.to(F32), params,
                                 opt_state["m"], grads))
    new_p = unflatten(params, _zip(
        lambda p, m: (p.to(F32) - lr * m).to(p.dtype), params, mom))
    return new_p, {"m": mom, "v": opt_state["v"]}, {"grad_norm": gnorm, "lr": lr}


UPDATES = {"adamw": adamw_update, "sgd": sgd_update}
