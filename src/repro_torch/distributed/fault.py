"""Fault tolerance: heartbeat monitoring + checkpoint/restart recovery
(host Python, copied from `repro.distributed.fault`).

At production scale (1000+ nodes) failures are routine; the recovery path
reuses the elastic migration machinery: detect -> restore the latest
checkpoint on the surviving slice (possibly smaller) -> continue. Failures
here are injected (single-host environment); the detection/recovery logic
is the deployable part.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class HeartbeatMonitor:
    """Tracks per-host heartbeats; flags hosts silent for > timeout_s.

    `clock` supplies the current time (defaults to `time.monotonic`) —
    inject a virtual clock to drive detection deterministically in
    scenarios and tests, without sleeps. Explicit `t`/`now` arguments
    still override per call."""

    timeout_s: float = 30.0
    last_seen: dict = field(default_factory=dict)
    clock: Callable[[], float] = time.monotonic

    def beat(self, host: str, t: Optional[float] = None):
        self.last_seen[host] = t if t is not None else self.clock()

    def dead_hosts(self, now: Optional[float] = None) -> list:
        now = now if now is not None else self.clock()
        return [h for h, t in self.last_seen.items() if now - t > self.timeout_s]


@dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/examples: {step: n_lost}.

    `persistent=True` re-arms the schedule instead of popping it — the
    same failure fires on every replay through its step, modelling a
    fault the recovery path cannot clear (a bad host that keeps
    rejoining, a corrupt shard). Use with `run_with_recovery`'s
    `max_retries` to exercise the exhaustion path.
    """

    schedule: dict = field(default_factory=dict)
    persistent: bool = False

    def check(self, step: int) -> int:
        # one-shot by default: recovery rolls back to the last checkpoint
        # and replays through this step; the same failure must not re-fire
        if self.persistent:
            return self.schedule.get(step, 0)
        return self.schedule.pop(step, 0)


def run_with_recovery(job, data_iter, n_steps: int, devices: list,
                      injector: Optional[FailureInjector] = None,
                      checkpoint_every: int = 20,
                      min_devices: int = 1,
                      max_retries: Optional[int] = None,
                      backoff_base_s: float = 0.0,
                      backoff_cap_s: float = 60.0,
                      sleep_fn: Callable[[float], None] = time.sleep) -> dict:
    """Train with periodic checkpoints; on (injected) failure, shrink the
    device set and resume from the latest checkpoint (elastic recovery).

    A failure that keeps firing at the same step used to loop forever.
    `max_retries` bounds *consecutive* recoveries that fail to advance
    past the failing step; each retry k first backs off
    `min(backoff_base_s * 2**(k-1), backoff_cap_s)` seconds (capped
    exponential; `sleep_fn` is injectable so tests pass a recorder
    instead of sleeping). On exhaustion — or when fewer than
    `min_devices` survive — the run aborts *gracefully*: it returns the
    partial results accumulated so far with `aborted=True` and an
    `abort_reason`, instead of raising away the completed work.
    """
    it = iter(data_iter)
    recoveries = []
    live = list(devices)
    step = job.step_idx
    consec = 0
    last_fail_step = -1

    def _partial(reason: str) -> dict:
        return {"recoveries": recoveries, "final_step": job.step_idx,
                "devices_left": len(live), "aborted": True,
                "abort_reason": reason}

    while step < n_steps:
        lost = injector.check(step) if injector else 0
        if lost:
            # consecutive = no forward progress past the last failing step
            consec = consec + 1 if step <= last_fail_step else 1
            last_fail_step = step
            if max_retries is not None and consec > max_retries:
                return _partial(f"max_retries={max_retries} exhausted at "
                                f"step {step}")
            if backoff_base_s > 0.0 and consec > 1:
                sleep_fn(min(backoff_base_s * 2.0 ** (consec - 2),
                             backoff_cap_s))
            survivors = live[:-lost] if lost < len(live) else []
            # power-of-two shrink so the mesh stays well-formed
            n = 1
            while n * 2 <= len(survivors):
                n *= 2
            survivors = survivors[:n]
            if len(survivors) < min_devices:
                return _partial(f"insufficient survivors at step {step}: "
                                f"{len(survivors)} < min_devices="
                                f"{min_devices}")
            resumed = job.recover_after_failure(survivors)
            recoveries.append({"at_step": step, "lost": lost,
                               "resumed": resumed})
            live = survivors
            step = job.step_idx
            continue
        job.train_step(next(it))
        step = job.step_idx
        if checkpoint_every and step % checkpoint_every == 0:
            job.checkpoint()
    return {"recoveries": recoveries, "final_step": step,
            "devices_left": len(live), "aborted": False}
