"""Elastic job: checkpoint -> build the mesh over another device subset ->
reshard -> restore -> rebuild the step (the reference's
`src/repro/core/elastic.py`).

The port's form of the reference's TPU-native CRIU. One process drives
one device; a job's devices are a subset of the processes of a
torch.distributed process group, named by their ranks or, on the card,
by ``cuda:r`` (rank r drives card r of its host). `mesh_over` lays a
(data x model) mesh over that subset, data-major as the reference does;
every process of the group builds it and the ones outside the subset
hold no state and skip the steps. `migrate` and `resume` snapshot the
state to one checkpoint (gathered, written once), then restore each
process's shards onto the new mesh, which is the reshard, bit for bit,
and rebuild the step. The same machinery serves fault recovery (restore
on the survivors) and the Carbon Containers migration mechanism.

Without a process group a job's devices are one device (a list of
length 1, as today on one card): the state lives there, unsharded, and
a migration restores it onto the new list's device. With one, every
process uses rank 0's ``ckpt_dir``: the processes share one host and
its file system.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.config import TrainConfig
from repro_torch.data.pipeline import to_device
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.models.sharding import Mesh
from repro_torch.spans import count, span
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import loop as TL


def _rank(device) -> int:
    """The process that drives `device`: an int rank, or ``cuda:r``."""
    if isinstance(device, int):
        return device
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is None:
        raise ValueError(f"a mesh names its devices by rank or as cuda:r; "
                         f"got {device!r}")
    return dev.index


def agree(value):
    """Rank 0's `value` (a picklable object) on every process of the
    process group; `value` itself without a group of more than one."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def mesh_over(devices: Sequence, model_axis: int = 1) -> Mesh:
    """Mesh over an explicit device subset (data-major), built by every
    process of the process group."""
    from repro_torch.launch.mesh import mesh_of_ranks
    n = len(devices)
    if n == 0 or n % model_axis:
        raise ValueError(f"{n} devices do not make a mesh with a model "
                         f"axis of {model_axis}")
    ranks = torch.tensor([_rank(d) for d in devices]).reshape(
        n // model_axis, model_axis)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return mesh_of_ranks(device_type, ranks, ("data", "model"))


@dataclass
class ElasticJob:
    """A training job that can move between device subsets ("slices")."""

    model: Model
    cfg: TrainConfig
    ckpt_dir: str

    def __post_init__(self):
        self.ckpt_dir = agree(self.ckpt_dir)
        self.device: Optional[torch.device] = None
        self.mesh: Optional[Mesh] = None
        self._step_fn: Optional[Callable] = None
        self.state = None
        self.manager = CKPT.CheckpointManager(self.ckpt_dir, keep=2,
                                              async_save=False)
        self.step_idx = 0
        self.migrations = []

    # -- lifecycle -----------------------------------------------------------
    def _place(self, devices: Sequence):
        if not devices:
            raise ValueError("an elastic job needs at least one device")
        if dist.is_initialized():
            self.mesh = mesh_over(devices)
            self.device = self.mesh.device if self.mesh.member else None
        else:
            if len(devices) != 1:
                raise ValueError(f"{len(devices)} devices need a process "
                                 f"group, one process a device")
            self.mesh, self.device = None, resolve_device(devices[0])

    @property
    def member(self) -> bool:
        """Whether this process holds a share of the job's state."""
        return self.mesh is None or self.mesh.member

    def state_shardings(self):
        """The state's placement on the job's mesh (None on one device)."""
        if self.mesh is None:
            return None
        return TL.state_shardings(self.model, self.cfg.optimizer, self.mesh)

    def start(self, devices: Sequence, seed=None):
        """Fresh state on `devices`; `seed` an int or a torch.Generator
        (default cfg.seed)."""
        self._place(devices)
        if self.member:
            self.state = TL.init_state(
                self.model, self.cfg.optimizer,
                self.cfg.seed if seed is None else seed, self.device,
                self.mesh)
        self._rebuild()

    def _rebuild(self):
        self._step_fn = (TL.make_train_step(self.model, self.cfg, self.mesh)
                         if self.member else None)

    def _restore(self) -> int:
        """Restore the latest checkpoint onto the current devices; returns
        its step (on every process)."""
        if not self.member:
            return self.manager.latest_step()
        abstract = TL.abstract_state(self.model, self.cfg.optimizer)
        self.state, step = self.manager.restore(
            abstract, device=self.device, shardings=self.state_shardings())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return step

    # -- the enforceable interface -------------------------------------------
    def train_step(self, batch) -> dict:
        """One step on the global batch; {} on a process outside the job's
        devices."""
        metrics = {}
        with span("train.step"):
            retries = self._alloc_retries()
            if self.member:
                if self.mesh is None:
                    batch = to_device(batch, self.device)
                self.state, metrics = self._step_fn(self.state, batch)
            self.step_idx += 1
            out = {k: float(v) for k, v in metrics.items()}
            if retries is not None:
                count("train.alloc_retries", self._alloc_retries() - retries)
        return out

    def _alloc_retries(self):
        """The caching allocator's retries so far on the job's card while a
        profiler records (`spans`); None otherwise."""
        dev = self.device
        if (dev is None or dev.type != "cuda"
                or not torch.autograd._profiler_enabled()):
            return None
        return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)

    def checkpoint(self) -> dict:
        """Write the state (on a mesh, gathered once and written by one
        process); every process returns the bytes written."""
        if self.member:
            self.manager.save(self.step_idx, self.state,
                              shardings=self.state_shardings())
        info = (self.manager.last_info() or {}) if self.member else {}
        if dist.is_initialized():
            dist.barrier()
            info = dict(info, bytes=CKPT.manifest(self.manager.step_dir(
                self.step_idx))["bytes"])
        return info

    def migrate(self, devices: Sequence) -> dict:
        """Stop-and-copy to another device subset; returns timing breakdown."""
        t0 = time.perf_counter()
        info = self.checkpoint()
        t1 = time.perf_counter()
        self._release()
        self._place(devices)
        self._restore()
        t2 = time.perf_counter()
        self._rebuild()
        rec = {"save_s": t1 - t0, "restore_s": t2 - t1,
               "bytes": info.get("bytes", 0), "n_devices": len(devices),
               "step": self.step_idx}
        self.migrations.append(rec)
        return rec

    def _release(self):
        """Drop the state and hand its device memory back."""
        dev = self.device
        self.state = None
        gc.collect()
        if dev is not None and dev.type == "cuda":
            torch.cuda.empty_cache()

    def suspend(self) -> dict:
        info = self.checkpoint()
        self._release()
        return info

    def resume(self, devices: Sequence) -> dict:
        self._place(devices)
        self.step_idx = self._restore()
        self._rebuild()
        return {"resumed_at_step": self.step_idx, "n_devices": len(devices)}

    # -- fault tolerance -------------------------------------------------------
    def recover_after_failure(self, surviving_devices: Sequence) -> dict:
        """Node failure: restore the latest checkpoint on the survivors."""
        return self.resume(surviving_devices)
