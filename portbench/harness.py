"""One run of one cell: set-up, the measured (or traced) window, the
comparison that decides ``correct``, and the result line.

Everything is found by name. `BENCHMARK.json` names the cell's
configuration and lists the metrics; ``configs/<config>.json`` holds
the configuration; ``workloads/<cell>.json`` holds the cell's traffic
parameters (its ``traffic.kind`` names the generator
``traffic/<kind>.py``) and the limits of its comparison;
``metrics/<metric>.py`` reads one per-layer metric from a ``--trace 1``
run. A traffic kind's module has ``setup(run) -> driver``; the driver
has ``window(seconds, tracer)``, ``release()`` and ``check()``. A
window returns its ``attempted`` and ``failed`` work, its end-to-end
``metrics`` and its ``ctx``: the shapes and the host's and the
program's readings that the per-layer readers take.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


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

    @property
    def m(self) -> dict:
        return self.conf["model"]

    @property
    def family(self) -> str:
        return self.conf["family"]

    @property
    def traffic(self) -> dict:
        return self.work["traffic"]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def _device_info(device, count: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def run_cell(manifest: dict, name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0: float | None = None, *,
             conf: dict | None = None, work: dict | None = None,
             model_cfg=None, log=print) -> dict:
    """Run cell `name` and return its result line (a dict). `conf`,
    `work` and `model_cfg` replace the files' and the registry's (the
    CPU tests run a cell at a small size)."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    w = cell(manifest, name)
    conf = conf or load_json(BENCH / "configs" / f"{w['config']}.json")
    work = work or load_json(BENCH / "workloads" / f"{name}.json")
    kind = load_module(BENCH / "traffic" / f"{work['traffic']['kind']}.py")
    readers = [(m, load_module(BENCH / "metrics" / f"{m['name']}.py"))
               for m in per_layer(manifest, name)] if trace else []
    run = Run(name, int(seed), device, conf, work,
              model_cfg or model_config(conf))
    t_card = time.perf_counter()
    if device.type == "cuda":
        torch.empty(1, device=device)          # the card's context
        torch.cuda.reset_peak_memory_stats(device)
    log(f"portbench: set-up: imports {t_card - t0:.2f} s, the card's start "
        f"{time.perf_counter() - t_card:.2f} s", file=sys.stderr)
    driver = kind.setup(run)
    setup_s = time.perf_counter() - t0
    out = driver.window(seconds)
    attempted, failed = out["attempted"], out["failed"]

    metrics = {}
    breakdown = None
    if trace:
        # a stretch traced after the measured window: the device's metrics
        # come from the trace, the host's and the program's counters from
        # the window, which the profiler does not slow
        from portbench.trace import Tracer
        tracer = Tracer(device)
        traced = driver.window(seconds, tracer)
        attempted += traced["attempted"]
        failed += traced["failed"]
        rec = tracer.record
        rec.ctx.update(family=run.family, m=run.m, traffic=run.traffic,
                       window=out["ctx"])
        for spec, mod in readers:
            value = mod.read(rec)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        busy_s, window_s = rec.busy_s, rec.window_s
        breakdown = rec.breakdown()
        del rec, tracer
    else:
        for spec in end_to_end(manifest, name):
            value = setup_s if spec["name"] == "setup_s" \
                else out["metrics"][spec["name"]]
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    info = _device_info(device, w["chips"])
    if trace:
        info.update(busy_s=busy_s, window_s=window_s)

    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = driver.check()
    log(f"portbench: the reference's comparison took "
        f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    compared = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    correct = (failed == 0 and bool(checks)
               and all(math.isfinite(v) and v <= lim for _, v, lim in checks))
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def check_lines(result: dict) -> list:
    """One line for each number compared, beside its limit."""
    return [f"portbench: compared {n} = {c['value']!r} (limit {c['limit']!r})"
            f" {'ok' if c['value'] <= c['limit'] else 'OVER'}"
            for n, c in result["compared"].items()]
