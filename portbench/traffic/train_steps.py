"""Traffic kind ``train_steps``: a training job driven step by step
through the Carbon Container's enforceable interface,
`repro_torch.core.elastic.ElasticJob.train_step`.

Parameters (the cell's ``traffic``): ``seq``, ``global_batch``,
``microbatch`` (rows a backward), ``remat`` (none | full | dots),
``optimizer`` (AdamW's settings; a constant learning rate: the window
stands for the middle of a run), ``check_steps`` (the steps that
set-up drives and the reference follows), ``trace_steps`` (steps of a
traced stretch), ``reference_rows`` (rows the reference takes at a
time) and, on several cards, ``model_axis`` (the cards of the mesh's
model axis; 1, data-parallel, where it is left out).

Set-up makes the state from the seed on the card (float32 masters,
AdamW's zero moments, step 0), places it in the job, and drives the
first ``check_steps`` steps through the window's own call and feed: each
step a new batch of token rows drawn from the seed, uniform over the
vocabulary. They are the warm-up too. It keeps what the comparison
needs: each step's loss, the first gradient as the optimizer got it
(from AdamW's first moment after one step and the step's global norm)
and the change of every parameter over those steps. The window runs
whole steps while less than ``seconds`` has passed.

On several cards (``run.world`` > 1, one process a card) the job is
placed over every rank's card, on the (data, model) mesh of
`core.elastic.mesh_over` with ``model_axis`` cards on the model axis:
each rank draws the same global batch from the seed and the step hands
each its rows; each rank keeps its shards of the state, drawn whole from
the seed one leaf at a time, and the comparison's norms are taken of
each leaf gathered whole. Rank 0 decides when a window ends, and
``train_tok_s`` counts the global batch. The window's ``microbatch`` is
the rows of a microbatch on one card, the batch that its kernels see.
"""
from __future__ import annotations

import contextlib
import gc
import math
import os
import sys
import tempfile
import time

import torch

from portbench.reference import common as C
from portbench.reference import drive

# the CPU tests' traffic: a few short rows
SMALL = {"seq": 32, "global_batch": 4, "microbatch": 2, "reference_rows": 2,
         "trace_steps": 1}


def setup(run):
    return TrainDriver(run)


class TrainDriver:
    def __init__(self, run):
        from repro_torch.config import OptimizerConfig, TrainConfig
        from repro_torch.core.elastic import ElasticJob
        from repro_torch.models.api import get_model
        from repro_torch.train.optimizer import adamw_init

        self.run = run
        t = run.traffic
        self.opt = dict(t["optimizer"])
        self.rows, self.seq = t["global_batch"], t["seq"]
        self.vocab = run.m["vocab_size"]
        self.layout = drive.family(run.family).layout(run.m)
        model = get_model(run.model_cfg)
        _same_tree(model, self.layout)
        tcfg = TrainConfig(
            seq_len=self.seq, global_batch=self.rows,
            microbatch=t["microbatch"], remat=t["remat"], seed=run.seed,
            optimizer=OptimizerConfig(
                lr=self.opt["lr"], warmup_steps=self.opt["warmup_steps"],
                schedule="constant", b1=self.opt["b1"], b2=self.opt["b2"],
                eps=self.opt["eps"], weight_decay=self.opt["weight_decay"],
                grad_clip=self.opt["grad_clip"]))
        t0 = time.perf_counter()
        ckpt = os.path.join(tempfile.gettempdir(), "portbench-checkpoints")
        self.job = ElasticJob(model, tcfg, ckpt)
        if run.world == 1:
            self.shardings = None
            params = C.nest(C.init_params(self.layout, run.seed, run.device))
            self.job._place([run.device])
        else:
            from repro_torch.core.elastic import mesh_over
            from repro_torch.models.params import flatten
            # what ElasticJob._place does, with the cell's model axis
            self.job.mesh = mesh_over(list(range(run.world)),
                                      t.get("model_axis", 1))
            self.job.device = self.job.mesh.device
            self.shardings = dict(flatten(model.shardings(self.job.mesh)))
            params = C.nest({
                p: self.shardings[p].shard(C.init_leaf(p, spec, run.seed,
                                                       run.device))
                for p, spec in self.layout.items()})
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=run.device)}
        self.job.state = state
        self.job._rebuild()
        # rows of a microbatch on one card: the microbatch over the mesh
        # axes that split it
        self.card_rows = t["microbatch"]
        if self.job.mesh is not None:
            mesh = self.job.mesh.for_batch((t["microbatch"], self.seq))
            self.card_rows //= math.prod(mesh.size(a) for a in mesh.batch)

        t1 = time.perf_counter()
        self.port = {"loss": []}
        self.next = 0
        check_s = []
        for _ in range(t["check_steps"]):
            ts = time.perf_counter()
            metrics = self._step()
            check_s.append(time.perf_counter() - ts)
            self.port["loss"].append(metrics["loss"])
            if self.next == 1:
                self.port["first_grad"] = self._first_grad(metrics)
        t2 = time.perf_counter()
        self.port["change"] = self._whole(
            self.job.state["params"],
            lambda f: C.change_norms(f, self.layout, run.seed))
        print(f"portbench: set-up: state {t1 - t0:.2f} s, check steps "
              f"{' + '.join(f'{x:.2f}' for x in check_s)} s, their change "
              f"{time.perf_counter() - t2:.2f} s", file=sys.stderr)

    def _batch(self, i: int) -> dict:
        return C.train_batch(self.run.seed, i, self.rows, self.seq,
                             self.vocab, self.run.device)

    def _step(self) -> dict:
        metrics = self.job.train_step(self._batch(self.next))
        self.next += 1
        return metrics

    def _first_grad(self, metrics: dict) -> dict:
        """The first step's gradient norms, leaf by leaf, from AdamW's
        first moment m = (1 - b1) · clip · g."""
        clip = self.opt["grad_clip"]
        scale = min(1.0, clip / max(metrics["grad_norm"], 1e-9)) \
            if clip > 0 else 1.0
        m = self._whole(self.job.state["opt"]["m"], C.leaf_norms)
        return {k: v / (1.0 - self.opt["b1"]) / scale for k, v in m.items()}

    def _whole(self, tree: dict, norms) -> dict:
        """`norms` ({path: tensor} -> {leaf: norm}) of the state `tree`; on
        several cards of each leaf gathered whole from its shards (a
        collective), one leaf at a time."""
        flat = C.flat(tree)
        if self.shardings is None:
            return norms(flat)
        out = {}
        for path, local in flat.items():
            out.update(norms({path: self.shardings[path].gather(local)}))
        return out

    def window(self, seconds: float, tracer=None) -> dict:
        """Whole steps while less than `seconds` has passed; under a
        tracer, ``trace_steps`` steps."""
        n_steps = self.run.traffic["trace_steps"] if tracer else None
        times, losses = [], []
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        ctx = tracer if tracer is not None else contextlib.nullcontext()
        with ctx:
            start = time.perf_counter()
            while self.run.agree(len(times) < n_steps if n_steps
                                 else time.perf_counter() - start < seconds):
                t = time.perf_counter()
                losses.append(self._step()["loss"])      # a host read: a sync
                times.append(time.perf_counter() - t)
            end = time.perf_counter()
        tokens = len(times) * self.rows * self.seq
        print(f"portbench: step seconds {times}", file=sys.stderr)
        seen = {"steps": len(times), "step_s": times, "window_s": end - start,
                "rows": self.rows, "seq": self.seq,
                "microbatch": self.card_rows, "chips": self.run.world}
        if tracer is not None:
            tracer.ctx.update(seen)
        return {"attempted": len(times),
                "failed": sum(not math.isfinite(x) for x in losses),
                "metrics": {"train_tok_s": tokens / (end - start)},
                "ctx": seen}

    def release(self):
        self.job.state = None
        self.job = None
        gc.collect()

    def check(self) -> list:
        t = self.run.traffic
        batches = [self._batch(i) for i in range(t["check_steps"])]
        ref = drive.follow_train(self.run.family, self.run.m, self.run.seed,
                                 batches, self.opt, "float32",
                                 rows=t["reference_rows"],
                                 device=self.run.device)
        return compare(self.port, ref, self.run.work["limits"])


def compare(port: dict, ref: dict, limits: dict) -> list:
    """[(name, value, limit)] of the numbers that the cell's limits name:
    the worst step's relative loss gap, the worst leaf's gap of the first
    gradient and of the change over the steps (leaves whose reference
    gradient is nought to rounding left out of the change)."""
    still = C.still_leaves(ref["first_grad"])
    numbers = {
        "loss_gap": lambda: C.loss_gap(port["loss"], ref["loss"]),
        "grad_gap": lambda: C.worst_leaf_gap(port["first_grad"],
                                             ref["first_grad"]),
        "change_gap": lambda: C.worst_leaf_gap(port["change"], ref["change"],
                                               still),
    }
    return [(n, numbers[n](), lim) for n, lim in limits.items()]


def _same_tree(model, layout: dict):
    """The program's parameter tree must be the layout the benchmark
    draws (paths and shapes)."""
    got = {p: tuple(t.shape) for p, t in C.flat(model.abstract()).items()}
    want = {p: tuple(s[0]) for p, s in layout.items()}
    if got != want:
        raise ValueError(f"the program's parameter tree {got} is not the "
                         f"benchmark's layout {want}")

