"""The traced stretch of a ``--trace 1`` run, read once from the
profiler's raw events, and what the per-layer readers ask of it.

The harness wraps a stretch of the window in `Tracer`: `torch.profiler`
over the host and the card, the program's kernel counter
(`repro_torch.kernels.cost.COUNTER`) on, and a ``portbench.window``
annotation whose span is the traced window. `Record` holds what the
readers need: the device's intervals (kernels, copies and sets), the
host's operations, the launch of each kernel, the kernel counter's
calls over the stretch and the traffic's own context (shapes, steps,
the serving engine's counters).
"""
from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict

import torch

WINDOW = "portbench.window"
MIN_GAP_NS = 10_000          # idle gaps shorter than 10 us are not labelled


class Tracer:
    """Context manager around the traced stretch; `record` after it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.record = None
        self.ctx: dict = {}

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        from repro_torch.kernels.cost import COUNTER
        self._counter = COUNTER
        COUNTER.reset()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(COUNTER.on())
        self._prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._stack.__exit__(*exc)
        if exc[0] is None:
            self.record = Record(self._prof, self.ctx,
                                 dict(self._counter.calls))
        return False


class Record:
    """What one traced stretch saw. Times in ns on the profiler's clock."""

    def __init__(self, prof, ctx: dict, calls: dict):
        self.ctx = ctx
        self.calls = calls
        self.device = []   # (start, end, name, correlation, linked)
        launches = {}              # correlation id -> (start, thread)
        ops = defaultdict(list)    # thread -> [(start, end, name)]
        win = None
        for e in prof.profiler.kineto_results.events():
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # the host's annotations are mirrored on the device's
                # timeline; they are not device work
                if (e.duration_ns() > 0 and not e.is_user_annotation()
                        and not e.name().startswith("portbench.")):
                    self.device.append((start, end, e.name(),
                                        e.correlation_id(),
                                        e.linked_correlation_id()))
                continue
            name = e.name()
            tid = e.start_thread_id()
            if name == WINDOW:
                win = (start, end, tid)
            elif name.startswith("cu"):
                launches[e.correlation_id()] = (start, tid)
            else:
                ops[tid].append((start, end, name))
        if win is None:
            raise RuntimeError("the traced stretch has no window annotation")
        self.t0, self.t1, self.main = win
        self.device.sort()
        self.launches = launches
        self.ops = {t: sorted(v) for t, v in ops.items()}
        self._starts = {t: [o[0] for o in v] for t, v in self.ops.items()}

    # -- the window and the device's busy time ---------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device's intervals, clipped to the window."""
        out = []
        for s, e, *_ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def spans(self, name: str) -> list:
        """[(start, end)] of the host operations named `name` on the
        window's thread (the harness's own annotations)."""
        return [(s, e) for s, e, n in self.ops.get(self.main, [])
                if n == name]

    def busy_within(self, spans: list) -> float:
        """Seconds of `spans` in which the device was busy."""
        busy = self.busy_intervals()
        total = 0
        for s0, e0 in spans:
            for s, e in busy:
                total += max(0, min(e, e0) - max(s, s0))
        return total / 1e9

    # -- kernels by name, and kernels under an autograd node -------------
    def kernel_seconds(self, pattern: str) -> tuple:
        """(device seconds, count) of the kernels whose name matches the
        regular expression `pattern`."""
        rx = re.compile(pattern)
        hits = [e - s for s, e, name, *_ in self.device if rx.search(name)]
        return sum(hits) / 1e9, len(hits)

    def _host_op(self, tid, t):
        """The innermost host operation on thread `tid` running at `t`."""
        starts = self._starts.get(tid, [])
        i = bisect.bisect_right(starts, t) - 1
        best = None
        for j in range(i, max(i - 20_000, -1), -1):
            s, e, name = self.ops[tid][j]
            if e >= t and (best is None or s >= best[0]):
                best = (s, e, name)
                break
        return best

    def under_node(self, node: str) -> tuple:
        """(device seconds of the kernels launched while the autograd
        node `node` ran, the node's calls). A node's function runs on
        the thread that launches its kernels."""
        key = f"autograd::engine::evaluate_function: {node}"
        spans = defaultdict(list)
        for tid, ops in self.ops.items():
            for s, e, name in ops:
                if name == key:
                    spans[tid].append((s, e))
        calls = sum(len(v) for v in spans.values())
        starts = {t: [s for s, _ in v] for t, v in spans.items()}
        total = 0
        for s, e, _, corr, linked in self.device:
            launch = self.launches.get(corr) or self.launches.get(linked)
            if launch is None or launch[1] not in spans:
                continue
            t, tid = launch
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and spans[tid][i][1] >= t:
                total += e - s
        return total / 1e9, calls

    # -- the breakdown ------------------------------------------------------
    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the host operation that ran on the window's thread at
        each gap's middle."""
        ops = defaultdict(int)
        for s, e, name, *_ in self.device:
            ops[name[:100]] += e - s
        gaps = defaultdict(int)
        prev = self.t0
        for s, e in self.busy_intervals() + [[self.t1, self.t1]]:
            if s - prev >= MIN_GAP_NS:
                op = self._host_op(self.main, (s + prev) // 2)
                gaps[op[2][:100] if op else "(no host operation)"] += s - prev
            prev = e
        rank = lambda d: [[k, v / 1e9] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
