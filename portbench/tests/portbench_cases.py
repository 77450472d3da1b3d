"""Small versions of the benchmark's cells for the CPU tests, and the
faults that the tests plant in the program.

Each size comes from the files that define the cell: the configuration
file's ``small`` widths, the workload file's ``small`` (``model``,
``traffic``) where the cell needs more, and the traffic kind's
``SMALL`` (a few short rows); the program's configuration is the
file's, field for field.

A fault is an importable function of a rank's `harness.Run` that
patches the program and returns a function that undoes the patch:
`harness.run_cell(faults=...)` applies it on every rank before its
set-up, and a spawned rank imports it by name.
"""
from __future__ import annotations

import dataclasses
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402

SEED = 2**33 + 7            # more than 32 bits, as the driver's seeds are


def manifest() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def small(cell: str, dtype: str = "float32", man: dict | None = None,
          traffic: dict | None = None) -> dict:
    """run_cell's keyword arguments for `cell` of `man` (the manifest) at
    the small size, in `dtype` (float32: the program and the reference
    agree to rounding); `traffic` overrides the small traffic."""
    from repro_torch.configs.registry import get_arch
    w = harness.cell(man or manifest(), cell)
    conf = harness.load_json(harness.BENCH / "configs"
                             / f"{w['config']}.json")
    work = harness.load_json(harness.BENCH / "workloads" / f"{cell}.json")
    more = work.get("small", {})
    conf["model"].update(conf["small"], **more.get("model", {}))
    kind = harness.load_module(harness.BENCH / "traffic"
                               / f"{work['traffic']['kind']}.py")
    work["traffic"].update(kind.SMALL, **more.get("traffic", {}),
                           **(traffic or {}))
    cfg = dataclasses.replace(
        get_arch(conf["registry"]).full, dtype=dtype,
        **{f: conf["model"][k] for k, f in conf["port_fields"].items()})
    return {"conf": conf, "work": work, "model_cfg": cfg}


def run_small(cell: str, trace: bool = False, seconds: float = 0.2,
              dtype: str = "float32", man: dict | None = None,
              traffic: dict | None = None, **kw) -> dict:
    man = man or manifest()
    return harness.run_cell(man, cell, SEED, seconds, trace, "cpu",
                            log=lambda *a, **k: None,
                            **small(cell, dtype, man, traffic), **kw)


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------

def unchanged_state(run):
    """AdamW hands back the state it was given."""
    from repro_torch.train import optimizer as OPT
    adamw = OPT.UPDATES["adamw"]

    def still(cfg, grads, opt_state, params, step, shardings=None):
        return params, opt_state, {"grad_norm": OPT.global_norm(grads),
                                   "lr": OPT.lr_at(cfg, step)}
    OPT.UPDATES["adamw"] = still
    return lambda: OPT.UPDATES.__setitem__("adamw", adamw)


def half_batch(run):
    """The loss leaves out the second half of the rows it is given: the
    mean is taken over the rest."""
    from repro_torch.models.api import Model
    loss = Model.loss

    def half(self, params, batch, remat="none", mesh=None):
        n = batch["tokens"].shape[0] // 2
        return loss(self, params, {k: v[:n] for k, v in batch.items()},
                    remat, mesh)
    Model.loss = half
    return lambda: setattr(Model, "loss", loss)


def rank_1_raises_in_setup(run):
    """Rank 1 raises in its first training step, which set-up drives."""
    from repro_torch.core.elastic import ElasticJob
    step = ElasticJob.train_step

    def raises(self, batch):
        if run.rank == 1:
            raise RuntimeError("a fault planted in rank 1's set-up")
        return step(self, batch)
    ElasticJob.train_step = raises
    return lambda: setattr(ElasticJob, "train_step", step)


def rank_1_loads_forbidden(run):
    """Rank 1 holds a module of a forbidden name, a stand-in for the JAX
    package that a rank-dependent path of the program might load."""
    if run.rank == 1:
        sys.modules["flax"] = types.ModuleType("flax")
