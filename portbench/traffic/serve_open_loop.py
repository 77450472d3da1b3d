"""Traffic kind ``serve_open_loop``: batches of equal-length requests
sent to `repro_torch.serve.engine.ServeEngine.generate` on a fixed
schedule, greedy.

Parameters (the cell's ``traffic``): ``batch`` (requests a batch),
``prompt`` (tokens a prompt), ``new_tokens``, ``interval_s`` (one batch
is due every interval: an open loop at a rate fixed below the engine's
capacity), ``trace_batches`` (batches of a traced stretch) and
``check_requests`` (served requests the reference reads, drawn from the
seed over every slot of a batch).

The engine returns a request's tokens when its batch is done, all at
once, so a request's first token reaches its client when `generate`
returns: its time to first token runs from the moment its batch was due
to that return, which counts any wait behind the batch before it.
Set-up makes the float32 masters from the seed on the card, loads them
into the engine (which casts them once for serving) and serves one
batch of the cell's shape. Prompt ids are uniform over the vocabulary,
drawn on the card from the seed and the batch's index.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np
import torch

from portbench.reference import common as C
from portbench.reference import drive

# the CPU tests' traffic: two short prompts a batch
SMALL = {"batch": 2, "prompt": 32, "interval_s": 0.02, "trace_batches": 2,
         "check_requests": 3}
WARM = -1            # the warm-up batch's index
BATCH = "portbench.batch"   # the span of one batch's generate


def setup(run):
    return ServeDriver(run)


class ServeDriver:
    def __init__(self, run):
        from repro_torch.models.api import get_model
        from repro_torch.serve.engine import ServeEngine

        if run.world > 1:
            raise ValueError(f"{run.name}: serve_open_loop serves from one "
                             f"card, not {run.world}")
        self.run = run
        t = run.traffic
        self.B, self.S, self.n_new = t["batch"], t["prompt"], t["new_tokens"]
        self.layout = drive.family(run.family).layout(run.m)
        t0 = time.perf_counter()
        params = C.nest(C.init_params(self.layout, run.seed, run.device))
        self.engine = ServeEngine(get_model(run.model_cfg), params=params,
                                  device=run.device)
        self.engine.prepared_params()
        t1 = time.perf_counter()
        self._serve(WARM)
        self.served = {}               # batch index -> tokens (B, n_new)
        self.next = 0                  # the next batch's index
        print(f"portbench: set-up: weights {t1 - t0:.2f} s, warm batch "
              f"{time.perf_counter() - t1:.2f} s", file=sys.stderr)

    def _prompts(self, j: int) -> torch.Tensor:
        return C.token_rows(self.run.seed, j, self.B, self.S,
                            self.run.m["vocab_size"], self.run.device)

    def _serve(self, j: int) -> np.ndarray:
        return self.engine.generate(self._prompts(j), self.n_new)["tokens"]

    def window(self, seconds: float, tracer=None) -> dict:
        """Batches due every ``interval_s`` while less than `seconds` has
        passed; under a tracer, ``trace_batches`` batches."""
        t = self.run.traffic
        interval = t["interval_s"]
        n_batches = t["trace_batches"] if tracer else None
        serve_s = []
        self.batch_latency = []
        stats0 = dict(self.engine.stats)
        ctx = tracer if tracer is not None else contextlib.nullcontext()
        with ctx:
            start = time.perf_counter()
            k = 0
            while (k < n_batches if n_batches
                   else k * interval < seconds):
                due = start + k * interval
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                t0 = time.perf_counter()
                with torch.profiler.record_function(BATCH):
                    self.served[self.next] = self._serve(self.next)
                done = time.perf_counter()
                serve_s.append(done - t0)
                self.batch_latency.append(done - due)
                self.next += 1
                k += 1
        stats = {n: self.engine.stats[n] - stats0[n] for n in stats0}
        print(f"portbench: batch seconds {serve_s}; engine {stats}",
              file=sys.stderr)
        seen = {"batches": k, "serve_s": serve_s, "rows": self.B,
                "seq": self.S, "new_tokens": self.n_new,
                "decode_s": stats["decode_s"],
                "decode_steps": stats["decode_tokens"] // self.B,
                "prefill_s": stats["prefill_s"], "chips": self.run.world}
        if tracer is not None:
            tracer.ctx.update(seen)
        return {"attempted": k * self.B, "failed": 0,
                "metrics": {"ttft_p95_s": float(np.percentile(
                    np.repeat(self.batch_latency, self.B), 95))},
                "ctx": seen}

    def release(self):
        self.engine = None
        gc.collect()

    def check(self) -> list:
        """The widest gap by which a served token's reference logit lies
        below the reference's best, over a sample of the served requests
        drawn from the seed."""
        rows, chosen = self.sample()
        params = C.init_params(self.layout, self.run.seed, self.run.device)
        ref = drive.served_logits(self.run.family, self.run.m, params, rows,
                                  self.n_new)
        return [("logit_gap", drive.widest_gap(ref, chosen),
                 self.run.work["limits"]["logit_gap"])]

    def sample(self) -> tuple:
        """(rows, chosen): each sampled request's prompt followed by its
        served tokens but the last, and the served tokens (on the card).
        The sample is drawn from the seed and spread over the batch's
        slots: each slot gives as many requests as any other, or one
        fewer."""
        batches = sorted(self.served)
        g = np.random.default_rng(C.sub_seed(self.run.seed, "sample"))
        n = min(self.run.traffic["check_requests"], len(batches) * self.B)
        extra = set(g.choice(self.B, size=n % self.B, replace=False).tolist())
        picked = {}                    # batch index -> slots
        for r in range(self.B):
            k = min(n // self.B + (r in extra), len(batches))
            for i in g.choice(len(batches), size=k, replace=False):
                picked.setdefault(batches[i], []).append(r)
        rows, chosen = [], []
        for j in sorted(picked):
            mine = sorted(picked[j])
            served = torch.as_tensor(self.served[j][mine],
                                     device=self.run.device).long()
            rows.append(torch.cat([self._prompts(j)[mine], served[:, :-1]], 1))
            chosen.append(served)
        return torch.cat(rows), torch.cat(chosen)
