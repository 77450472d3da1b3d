"""The port's serving scheduler, replay harness, fault-tolerance and
straggler modules against the reference's (host copies: equal outputs
on the same inputs), and the carbon-aware serving loop
(`repro_torch.launch.carbon_serve`) record for record against the
reference's loop, assembled from the reference's own modules exactly as
`examples/carbon_serve.py` assembles it."""
import numpy as np
import pytest

from repro.carbon.intensity import TraceProvider as RefTP
from repro.cluster.slices import paper_family as ref_paper_family
from repro.core.container import ContainerState as RefState
from repro.core.container import PlantModel as RefPlant
from repro.core.policy import CarbonContainerPolicy as RefCCP
from repro.distributed import fault as ref_fault
from repro.distributed.stragglers import StragglerDetector as RefDetector
from repro.serve import scheduler as ref_scheduler
from repro.workload.replay import ReplayHarness as RefHarness
from repro_torch.distributed import fault
from repro_torch.distributed.stragglers import StragglerDetector
from repro_torch.launch import carbon_serve
from repro_torch.serve import scheduler
from repro_torch.workload.replay import ReplayHarness


def _requests(sch):
    return [(r.arrival_s, r.rid, r.prompt_len, r.max_new, r.done_s)
            for r in sch.completed]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_equals_the_reference(seed):
    """Random offers (equal arrival times included, so heapq's order on
    ties counts) served under random duties and slices."""
    rng = np.random.default_rng(seed)
    sides = [mod.CarbonAwareScheduler(capacity_tok_s=10.0, interval_s=100.0)
             for mod in (scheduler, ref_scheduler)]
    for step in range(12):
        arrivals = np.round(rng.random(int(rng.integers(0, 9))) * 4) * 25.0
        arrivals += step * 100.0
        sizes = rng.integers(1, 400, arrivals.size)
        duty = float(rng.choice([0.0, 0.25, 0.5, 1.0]))
        mult = float(rng.choice([0.25, 1.0, 4.0]))
        outs = []
        for sch in sides:
            for a, m in zip(arrivals, sizes):
                sch.offer(float(a), prompt_len=7, max_new=int(m))
            outs.append((sch.demand(), sch.demand(window_s=37.0),
                         sch.run_interval(duty, mult),
                         sch.run_interval(duty, mult, interval_s=50.0)))
        assert outs[0] == outs[1]
        assert _requests(sides[0]) == _requests(sides[1])
        assert [(r.arrival_s, r.rid) for r in sides[0].queue] == [
            (r.arrival_s, r.rid) for r in sides[1].queue]
    assert len(sides[0].completed) > 10
    assert sides[0].latency_stats() == sides[1].latency_stats()


@pytest.mark.parametrize("rate,duration,seed", [(0.03, 300.0, 5),
                                                (0.5, 600.0, 7),
                                                (20.0, 600.0, 1),
                                                (3.0, 10_000.0, 2)])
def test_poisson_arrivals_equal_the_reference(rate, duration, seed):
    for chunk in (1, 3, 4096):
        got = scheduler.poisson_arrivals(rate, duration, seed=seed,
                                         chunk=chunk)
        assert got == ref_scheduler.poisson_arrivals(rate, duration,
                                                     seed=seed, chunk=chunk)
        assert got == scheduler.poisson_arrivals(rate, duration, seed=seed)


@pytest.mark.parametrize("trace", [[], [0.2, 0.4, 0.6],
                                   list(0.5 + 0.3 * np.sin(
                                       np.linspace(0, 4 * np.pi, 96)))])
def test_replay_harness_equals_the_reference(trace):
    def actuator(u):
        return round(u * 64.0) / 64.0
    h, ref = ReplayHarness(tolerance=0.05), RefHarness(tolerance=0.05)
    assert h.replay(trace, actuator) == ref.replay(trace, actuator)
    assert h.history == ref.history


def test_heartbeat_and_injector_equal_the_reference():
    out = []
    for mod in (fault, ref_fault):
        now = [0.0]
        mon = mod.HeartbeatMonitor(timeout_s=30.0, clock=lambda: now[0])
        inj = mod.FailureInjector(schedule={3: 1, 7: 2})
        sticky = mod.FailureInjector(schedule={4: 1}, persistent=True)
        log = []
        for t in range(12):
            now[0] = t * 10.0
            for h in ("a", "b", "c")[:3 - (t >= 4)]:
                mon.beat(h)
            mon.beat("x", t=5.0)
            log.append((mon.dead_hosts(), mon.dead_hosts(now=1e3),
                        inj.check(t), inj.check(t), sticky.check(4)))
        out.append(log)
    assert out[0] == out[1]


class _Job:
    """Minimal checkpointed trainer (duck-typed; no JAX)."""

    def __init__(self):
        self.step_idx = 0
        self.ckpt_step = 0
        self.devices = None
        self.losses = []

    def train_step(self, batch):
        self.losses.append(batch)
        self.step_idx += 1

    def checkpoint(self):
        self.ckpt_step = self.step_idx

    def recover_after_failure(self, survivors):
        self.devices = list(survivors)
        self.step_idx = self.ckpt_step
        del self.losses[self.ckpt_step:]
        return {"resumed_at": self.step_idx, "devices": len(survivors)}


@pytest.mark.parametrize("schedule,persistent,kw", [
    ({25: 3}, False, {}),
    ({5: 1, 12: 2, 30: 1}, False, {"checkpoint_every": 4}),
    ({15: 1}, True, {"max_retries": 3, "backoff_base_s": 0.5,
                     "backoff_cap_s": 1.5}),
    ({3: 7}, False, {"min_devices": 2}),
])
def test_run_with_recovery_equals_the_reference(schedule, persistent, kw):
    outs = []
    for mod in (fault, ref_fault):
        job, sleeps = _Job(), []
        res = mod.run_with_recovery(
            job, iter(range(10_000)), n_steps=40, devices=list(range(8)),
            injector=mod.FailureInjector(schedule=dict(schedule),
                                         persistent=persistent),
            sleep_fn=sleeps.append, **{"checkpoint_every": 10, **kw})
        outs.append((res, sleeps, job.losses, job.devices))
    assert outs[0] == outs[1]


def test_straggler_detector_equals_the_reference():
    rng = np.random.default_rng(13)
    times = np.clip(rng.normal(1.0, 0.03, 200), 0.9, 1.1)
    times[60:120] *= 2.6
    det, ref = StragglerDetector(), RefDetector()
    for t in times:
        assert det.observe(float(t)) == ref.observe(float(t))
        assert det.slowdown() == ref.slowdown()


def _reference_loop(tok_s, intervals=96):
    """examples/carbon_serve.py's loop, from the reference's modules."""
    fam = ref_paper_family()
    policy = RefCCP(variant="energy")
    state = RefState(slice_idx=fam.baseline_idx)
    carbon = RefTP.for_region("CAISO", hours=48, seed=3)
    sch = ref_scheduler.CarbonAwareScheduler(capacity_tok_s=tok_s)
    target = 45.0
    interval = 300.0
    records = []
    emissions, hours_total = 0.0, 0.0
    for n in range(intervals):
        t = n * interval
        lam = 0.03 * (3.0 if 30 <= n < 60 else 1.0)
        for a in ref_scheduler.poisson_arrivals(lam, interval, seed=n):
            sch.offer(t + a, max_new=32)
        c = carbon.intensity(t)
        demand = min(sch.demand(interval), 4.0)
        state.observe_demand(demand)
        action = policy.decide(fam, state, demand, c, target, 0.05)
        if action.kind == "migrate":
            state.slice_idx = action.target_slice
            state.dwell = 0
        state.duty = action.duty if action.kind in (
            "stay", "migrate", "resume") else 0.0
        state.suspended = action.kind == "suspend"
        state.dwell += 1
        s = fam[state.slice_idx]
        res = sch.run_interval(state.duty if not state.suspended else 0.0,
                               s.multiple, interval)
        served_util = min(res["util"], s.multiple)
        power = 0.0 if state.suspended else s.power.power(
            min(served_util / s.multiple, 1.0))
        rate = RefPlant.rate(power, c)
        emissions += rate * interval / 3600.0
        hours_total += interval / 3600.0
        records.append({"t": t, "c": c, "demand": demand, "slice": s.name,
                        "duty": state.duty, "rate": rate,
                        "served": res["served"], "backlog": res["backlog"],
                        "kind": action.kind})
    return records, emissions / hours_total, sch.latency_stats()


@pytest.mark.parametrize("tok_s", [0.4, 1.5, 49.0, 400.0])
def test_control_loop_equals_the_references(tok_s):
    records, sch = carbon_serve.control_loop(tok_s)
    want, avg_rate, lat = _reference_loop(tok_s)
    assert len(records) == 96
    for got, ref in zip(records, want):
        assert got == ref
    s = carbon_serve.summary(records, sch)
    assert s == {"avg_rate": avg_rate, **lat}


def test_control_loop_takes_several_actions():
    """At a decode capacity like the card's (tens of tokens a second) the
    loop migrates down, then throttles the duty below 1 at the baseline
    slice; at a fraction of a token a second the backlog builds."""
    records, _ = carbon_serve.control_loop(49.0)
    assert {"stay", "migrate"} <= {r["kind"] for r in records}
    assert len({r["slice"] for r in records}) >= 2
    assert 0.0 < min(r["duty"] for r in records) < 1.0
    records, sch = carbon_serve.control_loop(0.4)
    assert max(r["backlog"] for r in records) > 0
    assert carbon_serve.summary(records, sch)["p95_s"] > 0.0


def test_carbon_serve_main_runs_on_the_cpu(capsys):
    assert carbon_serve.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "decode capacity" in out and "avg C(t)" in out
    assert len([ln for ln in out.splitlines() if ln.startswith("  ")]) == 13
