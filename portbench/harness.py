"""One run of one cell: set-up, the measured (or traced) window, the
comparison that decides ``correct``, and the result line.

Everything is found by name. `BENCHMARK.json` names the cell's
configuration and lists the metrics; ``configs/<config>.json`` holds
the configuration (its ``family`` names the plain reference
``reference/<family>.py`` and the counts ``roofline/<family>.py``);
``workloads/<cell>.json`` holds the cell's traffic parameters (its
``traffic.kind`` names the generator ``traffic/<kind>.py``) and the
limits of its comparison; ``metrics/<metric>.py`` reads one per-layer
metric from a ``--trace 1`` run. The CPU tests' small size is the
configuration's ``small``, the workload's ``small`` and the kind's
``SMALL``. A traffic kind's module has ``setup(run) -> driver``; the driver
has ``window(seconds, tracer)``, ``release()`` and ``check()``. A
window returns its ``attempted`` and ``failed`` work, its end-to-end
``metrics`` and its ``ctx``: the shapes and the host's and the
program's readings (with ``chips``) that the per-layer readers take.

A cell on one card runs in the calling process. A cell on ``chips`` > 1
cards runs one process a card, as the program's mesh does: rank 0 in
the calling process, ranks 1 .. chips - 1 started by
`torch.multiprocessing`'s "spawn", each in `torch.distributed`'s process
group (NCCL, rank r on ``cuda:r``; gloo on the CPU). Every rank runs the
same set-up, windows and ``release``; rank 0 decides when a window ends
(`Run.agree`), reads the per-layer metrics from its own trace and, once
every other rank has released and exited, runs ``check()`` alone.
``setup_s`` runs to the moment the last rank is set up;
``memory_peak_bytes`` is the fullest card's peak; traced, every rank
traces and ``busy_s`` and ``window_s`` are the ranks' means. A rank that
raises or dies fails the run in bounded time (the process group's
timeout, the join's, and a watch on the ranks), and so does one that
holds a module of `FORBIDDEN` once its windows have closed.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import importlib.util
import json
import math
import os
import socket
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GROUP_TIMEOUT_S = 600   # a collective (or the group's start) that waits longer
JOIN_TIMEOUT_S = 120    # for the ranks to exit once rank 0 has measured
WATCH_GRACE_S = 20      # after a rank died, for rank 0 to fail on its own


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no benchmark module {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; choose from "
                   f"{[w['name'] for w in manifest['workloads']]}")


def end_to_end(manifest: dict, name: str) -> list:
    return [m for m in manifest["end_to_end"]
            if name in m.get("workloads", [name])]


def per_layer(manifest: dict, name: str) -> list:
    """The per-layer metrics whose ``workloads`` list the cell."""
    return [m for m in manifest["per_layer"] if name in m["workloads"]]


def model_config(conf: dict):
    """The program's configuration of `conf` (its registry entry at full
    size), held to the file's numbers."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(conf["registry"]).full
    got = {k: getattr(cfg, f) for k, f in conf["port_fields"].items()}
    want = {k: conf["model"][k] for k in conf["port_fields"]}
    if got != want:
        raise ValueError(f"{conf['registry']}: the program's configuration "
                         f"{got} is not the file's {want}")
    return dataclasses.replace(cfg, dtype=conf["precision"]["activations"])


@dataclasses.dataclass
class Run:
    """What a traffic kind's set-up is given."""
    name: str
    seed: int
    device: torch.device
    conf: dict          # configs/<config>.json
    work: dict          # workloads/<cell>.json
    model_cfg: object   # the program's ModelConfig
    rank: int = 0       # this process's rank: one process a card
    world: int = 1      # the cell's chips

    @property
    def m(self) -> dict:
        return self.conf["model"]

    @property
    def family(self) -> str:
        return self.conf["family"]

    @property
    def traffic(self) -> dict:
        return self.work["traffic"]

    def agree(self, value: bool) -> bool:
        """Rank 0's `value` on every rank (a collective): a window goes
        on while rank 0 says so. `value` itself on one card."""
        if self.world == 1:
            return value
        flag = torch.tensor([float(value)], device=self.device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    def gather(self, values: list) -> list:
        """[each rank's `values`] in rank order (a collective of float64s);
        [`values`] on one card."""
        if self.world == 1:
            return [list(values)]
        mine = torch.tensor(values, dtype=torch.float64, device=self.device)
        out = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(out, mine)
        return [t.tolist() for t in out]


@dataclasses.dataclass
class Cell:
    """One run's arguments, as every rank gets them."""
    manifest: dict
    name: str
    seed: int
    seconds: float
    trace: bool
    conf: dict
    work: dict
    model_cfg: object
    faults: tuple       # importable functions of a Run, applied before set-up

    @property
    def chips(self) -> int:
        return cell(self.manifest, self.name)["chips"]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def _peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _device_info(device, count: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": peak}


def run_cell(manifest: dict, name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0: float | None = None, *,
             conf: dict | None = None, work: dict | None = None,
             model_cfg=None, faults=(), log=print,
             peek: Callable | None = None) -> dict:
    """Run cell `name` and return its result line (a dict). `conf`,
    `work` and `model_cfg` replace the files' and the registry's (the
    CPU tests run a cell at a small size); each of `faults` (importable
    functions, so that a spawned rank can call them) is called with
    every rank's `Run` before its set-up and may return a function that
    undoes it in this process; `peek(driver)` sees rank 0's driver
    before the check."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    w = cell(manifest, name)
    conf = conf or load_json(BENCH / "configs" / f"{w['config']}.json")
    work = work or load_json(BENCH / "workloads" / f"{name}.json")
    c = Cell(manifest, name, int(seed), seconds, trace, conf, work,
             model_cfg or model_config(conf), tuple(faults))
    undo = []
    try:
        if c.chips == 1:
            got = _measure(c, Run(name, c.seed, device, conf, work,
                                  c.model_cfg), t0, log, undo)
        else:
            got = _on_ranks(c, device, t0, log, undo)
        return _judge(got, log, peek)
    finally:
        for u in reversed(undo):
            u()


def _measure(c: Cell, run: Run, t0: float, log, undo: list) -> dict:
    """One rank's set-up, measured window and traced stretch, and its
    release; rank 0 returns what the result line needs."""
    kind = load_module(BENCH / "traffic" / f"{run.traffic['kind']}.py")
    readers = [(m, load_module(BENCH / "metrics" / f"{m['name']}.py"))
               for m in per_layer(c.manifest, c.name)] \
        if c.trace and run.rank == 0 else []
    t_card = time.perf_counter()
    if run.device.type == "cuda":
        torch.empty(1, device=run.device)      # the card's context
        torch.cuda.reset_peak_memory_stats(run.device)
    log(f"portbench: set-up: imports {t_card - t0:.2f} s, the card's start "
        f"{time.perf_counter() - t_card:.2f} s", file=sys.stderr)
    for fault in c.faults:
        u = fault(run)
        if u is not None:
            undo.append(u)
    driver = kind.setup(run)
    stamps = run.gather([t0, t_card, time.perf_counter()])
    setup_s = time.perf_counter() - t0
    if run.world > 1:
        log("portbench: set-up of each rank (s after rank 0's start: "
            "process up, card up, set up): "
            + "; ".join(f"{r}: {a - t0:.2f}, {b - t0:.2f}, {e - t0:.2f}"
                        for r, (a, b, e) in enumerate(stamps)),
            file=sys.stderr)
    out = driver.window(c.seconds)
    attempted, failed = out["attempted"], out["failed"]

    metrics = {}
    breakdown = busy_s = window_s = None
    if c.trace:
        # a stretch traced after the measured window: the device's metrics
        # come from the trace, the host's and the program's counters from
        # the window, which the profiler does not slow
        from portbench.trace import Tracer
        tracer = Tracer(run.device)
        traced = driver.window(c.seconds, tracer)
        attempted += traced["attempted"]
        failed += traced["failed"]
        rec = tracer.record
        ranks = run.gather([rec.busy_s, rec.window_s])
        busy_s, window_s = (sum(r[i] for r in ranks) / len(ranks)
                            for i in (0, 1))
        rec.ctx.update(family=run.family, m=run.m, traffic=run.traffic,
                       window=out["ctx"])
        for spec, mod in readers:
            value = mod.read(rec)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        if run.rank == 0:
            breakdown = rec.breakdown()
        del rec, tracer
    else:
        for spec in end_to_end(c.manifest, c.name):
            value = setup_s if spec["name"] == "setup_s" \
                else out["metrics"][spec["name"]]
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    peak = max(int(p) for (p,) in run.gather([_peak_bytes(run.device)]))
    info = _device_info(run.device, run.world, peak)
    if c.trace:
        info.update(busy_s=busy_s, window_s=window_s)
    driver.release()
    return {"driver": driver, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": info, "breakdown": breakdown}


def _judge(got: dict, log, peek) -> dict:
    """Rank 0, every card free: the comparison that decides ``correct``,
    and the result line."""
    driver = got["driver"]
    gc.collect()
    if got["device"]["platform"] == "gpu":
        torch.cuda.empty_cache()
    if peek is not None:
        peek(driver)
    t_check = time.perf_counter()
    checks = driver.check()
    log(f"portbench: the reference's comparison took "
        f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    compared = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    failed = got["failed"]
    correct = (failed == 0 and bool(checks)
               and all(math.isfinite(v) and v <= lim for _, v, lim in checks))
    result = {"correct": correct, "attempted": got["attempted"],
              "failed": failed, "metrics": got["metrics"],
              "device": got["device"]}
    if got["breakdown"] is not None:
        result["breakdown"] = got["breakdown"]
    result["compared"] = compared
    return result


# ---------------------------------------------------------------------------
# One process a card
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join_group(c: Cell, rank: int, device_type: str, port: int) -> Run:
    """This process's place in the cell's process group, and its Run."""
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = kw["device_id"] = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", world_size=c.chips,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
        **kw)
    return Run(c.name, c.seed, device, c.conf, c.work, c.model_cfg,
               rank, c.chips)


def _rank_main(c: Cell, rank: int, device_type: str, port: int,
               parent: int):
    """Ranks 1 .. chips - 1 (spawned): the same set-up, windows and
    release as rank 0. A rank that raises exits at once, without leaving
    the process group, where the others may be waiting in a collective;
    one that holds a module of `FORBIDDEN` once its windows have closed
    names it and exits with 3."""
    t0 = time.perf_counter()
    _end_with(parent)
    if device_type == "cpu":
        torch.set_num_threads(1)       # the ranks share the host's cores
    try:
        run = _join_group(c, rank, device_type, port)
        _measure(c, run, t0, lambda *a, **k: None, [])
        dist.destroy_process_group()
        found = forbidden_modules()
        if found:
            print(f"portbench: rank {rank} loaded {found}", file=sys.stderr,
                  flush=True)
            os._exit(3)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _end_with(parent: int):
    """This process ends when the process that started it does (Linux's
    parent-death signal); at once if it already has."""
    import ctypes
    import signal
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))
    except (OSError, AttributeError):
        return
    if os.getppid() != parent:
        os._exit(1)


class _Watch:
    """Watches the spawned ranks while rank 0 runs: where one exits with
    an error and rank 0 has not failed `WATCH_GRACE_S` later (it waits in
    a collective that nothing will complete), ends this process."""

    def __init__(self, procs: list):
        self.procs = procs
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _watch(self):
        while not self.done.wait(0.5):
            dead = _failed(self.procs)
            if dead and not self.done.wait(WATCH_GRACE_S):
                print(f"portbench: {dead}; rank 0 still waits: ending the "
                      f"run", file=sys.stderr, flush=True)
                for p in self.procs:
                    if p.is_alive():
                        p.kill()
                os._exit(1)

    def stop(self):
        self.done.set()
        self.thread.join()


def _failed(procs: list) -> str:
    """The spawned ranks that exited with an error ('' if none)."""
    return ", ".join(f"rank {r} exited with {p.exitcode}"
                     for r, p in enumerate(procs, 1)
                     if p.exitcode not in (None, 0))


def _on_ranks(c: Cell, device, t0: float, log, undo: list) -> dict:
    """Cell `c` on `c.chips` processes, one a card; rank 0's measurement,
    once every other rank has exited."""
    import torch.multiprocessing as mp
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        c, r, device.type, port, os.getpid()))
        for r in range(1, c.chips)]
    for p in procs:
        p.start()
    watch = _Watch(procs)
    try:
        try:
            got = _measure(c, _join_group(c, 0, device.type, port), t0,
                           log, undo)
            # every rank leaves the group together: NCCL's teardown waits
            # for the others'
            dist.destroy_process_group()
        except Exception as e:
            for p in procs:            # a rank's own failure, where it had one
                p.join(5)
            if _failed(procs):
                raise RuntimeError(f"portbench: {_failed(procs)}") from e
            raise
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        bad = _failed(procs) or ", ".join(
            f"rank {r} did not exit" for r, p in enumerate(procs, 1)
            if p.exitcode is None)
        if bad:
            raise RuntimeError(f"portbench: {bad}")
        return got
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        if dist.is_initialized():      # after a failure (the watch bounds it)
            dist.destroy_process_group()
        watch.stop()


def check_lines(result: dict) -> list:
    """One line for each number compared, beside its limit."""
    return [f"portbench: compared {n} = {c['value']!r} (limit {c['limit']!r})"
            f" {'ok' if c['value'] <= c['limit'] else 'OVER'}"
            for n, c in result["compared"].items()]
