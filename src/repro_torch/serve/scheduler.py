"""Carbon-aware request scheduler (host Python, copied from
`repro.serve.scheduler`: the same queue order and the same arrivals).

Serving is where the paper's workload-intensity argument bites: request
rates swing on minutes-scale (Azure-like CoV ≫ carbon CoV), so the
scheduler feeds the Carbon Container demand signal with the queue-implied
utilization and applies the resulting duty/slice decisions — batching
requests up to the capacity the carbon policy allows.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass(order=True)
class Request:
    arrival_s: float
    rid: int = field(compare=False)
    prompt_len: int = field(compare=False, default=128)
    max_new: int = field(compare=False, default=64)
    done_s: Optional[float] = field(compare=False, default=None)


@dataclass
class CarbonAwareScheduler:
    """Queue + admission control driven by the carbon policy's duty."""

    capacity_tok_s: float            # decode throughput at duty=1 on slice 1x
    max_batch: int = 32
    interval_s: float = 300.0        # default epoch for demand/run_interval
    queue: list = field(default_factory=list)
    completed: list = field(default_factory=list)
    t: float = 0.0
    _next_rid: int = 0

    def offer(self, arrival_s: float, prompt_len: int = 128,
              max_new: int = 64) -> Request:
        r = Request(arrival_s, self._next_rid, prompt_len, max_new)
        self._next_rid += 1
        heapq.heappush(self.queue, r)
        return r

    def demand(self, window_s: Optional[float] = None) -> float:
        """Queue-implied utilization (baseline-capacity units) over the
        scheduler's interval (or an explicit `window_s`)."""
        if window_s is None:
            window_s = self.interval_s
        backlog_tokens = sum(r.max_new for r in self.queue)
        return backlog_tokens / max(self.capacity_tok_s * window_s, 1e-9)

    def run_interval(self, duty: float, slice_multiple: float,
                     interval_s: Optional[float] = None) -> dict:
        """Serve as many requests as the allowed capacity covers."""
        if interval_s is None:
            interval_s = self.interval_s
        budget_tokens = self.capacity_tok_s * slice_multiple * duty * interval_s
        served = 0
        tokens = 0
        while self.queue and tokens + self.queue[0].max_new <= budget_tokens:
            r = heapq.heappop(self.queue)
            if r.arrival_s > self.t + interval_s:
                heapq.heappush(self.queue, r)
                break
            tokens += r.max_new
            # completion can't precede arrival: a request arriving
            # mid-interval is served in the remainder of the interval
            r.done_s = max(r.arrival_s, self.t + interval_s
                           * min(1.0, tokens / max(budget_tokens, 1e-9)))
            self.completed.append(r)
            served += 1
        self.t += interval_s
        # utilization of the *baseline* capacity: budget_tokens already
        # carries the duty * slice_multiple scaling, so dividing served
        # tokens by it and multiplying by duty * slice_multiple again
        # (as earlier revisions did) double-counted the allocation
        return {"served": served, "tokens": tokens,
                "backlog": len(self.queue),
                "util": tokens / max(self.capacity_tok_s * interval_s, 1e-9)}

    def latency_stats(self) -> dict:
        lat = [r.done_s - r.arrival_s for r in self.completed
               if r.done_s is not None]
        if not lat:
            return {"p50_s": 0.0, "p95_s": 0.0, "n": 0}
        return {"p50_s": float(np.percentile(lat, 50)),
                "p95_s": float(np.percentile(lat, 95)), "n": len(lat)}


def poisson_arrivals(rate_per_s: float, duration_s: float,
                     seed: int = 0, chunk: int = 4096) -> list:
    """Arrival times of a homogeneous Poisson process on [0, duration_s].

    Vectorized: draws inter-arrival gaps in chunks and integrates them
    with one `cumsum` per chunk instead of one Python-loop iteration per
    event (~50x at serving-scale rates). Chunked array draws consume the
    generator stream exactly as repeated scalar draws do, so the output
    is bit-identical to the sequential reference for any chunk size
    (pinned by tests/test_scheduler_replay.py and, for this copy,
    tests/test_torch_scheduler.py).
    """
    rng = np.random.default_rng(seed)
    scale = 1.0 / max(rate_per_s, 1e-9)
    out: list = []
    carry = 0.0
    while True:
        gaps = rng.exponential(scale, chunk)
        t = np.cumsum(np.concatenate(([carry], gaps)))[1:]
        keep = t[t <= duration_s]
        out.extend(keep.tolist())
        if keep.size < chunk:
            return out
        carry = float(t[-1])
