"""The reference's runs: it follows a training run's first steps from the
seeded state, or reads its logits over served prompts and tokens.

Both work in blocks of rows so that they fit the card beside nothing
else: they run once the program's state has been freed. A model family's
reference is the module ``reference/<family>.py`` (`family`), so that a
new family comes as a new file.
"""
from __future__ import annotations

import importlib
import math

import torch

from portbench.reference import common as C


def family(name: str):
    """The plain reference of model family `name`: the module
    ``reference/<name>.py``, with ``layout(m)`` (the parameter tree's
    shapes and initial distributions), ``nll_sum(m, P, tokens, labels,
    q)`` and ``last_logits(m, P, tokens, n_last, q)``."""
    return importlib.import_module(f"portbench.reference.{name}")


def _split(params: dict) -> tuple:
    """(P, leaves): P as the family modules take it (each stacked leaf
    split into one leaf a layer: views of the stacked tensor, so an
    update of a layer's leaf updates the stack) and every leaf."""
    P = {"layers": []}
    leaves = []
    for path, t in params.items():
        if path.startswith("layers/"):
            views = [v.detach().requires_grad_() for v in t.unbind(0)]
            while len(P["layers"]) < len(views):
                P["layers"].append({})
            for lp, v in zip(P["layers"], views):
                lp[path[len("layers/"):]] = v
            leaves += views
        else:
            P[path] = t.detach().requires_grad_()
            leaves.append(P[path])
    return P, leaves


def _leaf_grad_norms(P: dict) -> dict:
    """{leaf: norm of its gradient}, leaves named as `common.leaf_norms`
    names them."""
    out = {}
    for path, t in P.items():
        if path != "layers":
            out[path] = float(torch.linalg.vector_norm(t.grad.reshape(-1),
                                                       dtype=torch.float64))
    for i, lp in enumerate(P["layers"]):
        for k, t in lp.items():
            out[f"layers/{k}[{i}]"] = float(torch.linalg.vector_norm(
                t.grad.reshape(-1), dtype=torch.float64))
    return out


def follow_train(family_name: str, m: dict, seed: int, batches, opt: dict,
                 precision: str = "float32", rows: int = 1,
                 device="cuda", keep_rows=None) -> dict:
    """The reference's run of the steps whose batches `batches` lists
    (dicts of int32 tokens and labels), from the seeded state, in
    `precision`, `rows` rows of a batch at a time. ``keep_rows`` (a
    fault, for the harness's tests) keeps only the first rows of each
    batch. Returns {"loss": [per step], "grad_norm": the first step's
    global norm, "first_grad": {leaf: norm of the first step's
    gradient}, "change": {leaf: norm of the change over the steps}}."""
    C.no_tf32()
    fam = family(family_name)
    q = C.PRECISIONS[precision]
    layout = fam.layout(m)
    params = C.init_params(layout, seed, device)
    P, leaves = _split(params)
    mom = [torch.zeros_like(p) for p in leaves]
    vel = [torch.zeros_like(p) for p in leaves]
    out = {"loss": []}
    for step, batch in enumerate(batches):
        tokens, labels = batch["tokens"], batch["labels"]
        if keep_rows:
            tokens, labels = tokens[:keep_rows], labels[:keep_rows]
        n = labels.numel()
        total = 0.0
        for r0 in range(0, tokens.shape[0], rows):
            with torch.enable_grad():
                nll = fam.nll_sum(m, P, tokens[r0:r0 + rows],
                                  labels[r0:r0 + rows], q)
                (nll / n).backward()
            total += float(nll.detach())
        out["loss"].append(total / n)
        if step == 0:
            out["first_grad"] = _leaf_grad_norms(P)
        gnorm = C.adamw_step(opt, step, leaves, mom, vel)
        if step == 0:
            out["grad_norm"] = gnorm
    del mom, vel, P, leaves
    out["change"] = C.change_norms(params, layout, seed)
    return out


def served_logits(family_name: str, m: dict, params: dict,
                  rows: torch.Tensor, n_served: int,
                  precision: str = "float32", block: int = 4) -> torch.Tensor:
    """float32 logits (R, n_served, V) at the positions where the served
    tokens were chosen: `rows` (R, S + n_served - 1) are each prompt
    followed by all but the last served token."""
    C.no_tf32()
    fam = family(family_name)
    q = C.PRECISIONS[precision]
    P, _ = _split(params)
    with torch.no_grad():
        return torch.cat([fam.last_logits(m, P, rows[r0:r0 + block],
                                          n_served, q)
                          for r0 in range(0, rows.shape[0], block)])


def widest_gap(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """The widest gap by which a chosen token's reference logit lies below
    the reference's best at its position (0 where it is the best)."""
    best = ref.max(-1).values
    got = torch.gather(ref, -1, chosen.long()[..., None])[..., 0]
    g = float((best - got).max())
    return g if math.isfinite(g) else math.inf
