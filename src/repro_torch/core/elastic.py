"""Elastic job: checkpoint -> restore onto another device -> rebuild the
step (the reference's `src/repro/core/elastic.py`).

The single-card form of the reference's TPU-native CRIU: a job's state
lives on the first device of its device list; `migrate` and `resume`
snapshot it to a checkpoint and restore it onto the first device of the
target list, then rebuild the step. The same machinery serves fault
recovery (restore on the survivors) and the Carbon Containers migration
mechanism. The reference's ``mesh_over`` (a data x model mesh over a
device subset) has no single-card meaning and is not ported (ROADMAP
item 16).
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from repro_torch.config import TrainConfig
from repro_torch.data.pipeline import to_device
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import loop as TL


@dataclass
class ElasticJob:
    """A training job that can move between device lists ("slices")."""

    model: Model
    cfg: TrainConfig
    ckpt_dir: str

    def __post_init__(self):
        self.device: Optional[torch.device] = None
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
        self.device = resolve_device(devices[0])

    def start(self, devices: Sequence, seed=None):
        """Fresh state on devices[0]; `seed` an int or a torch.Generator
        (default cfg.seed)."""
        self._place(devices)
        self.state = TL.init_state(self.model, self.cfg.optimizer,
                                   self.cfg.seed if seed is None else seed,
                                   self.device)
        self._rebuild()

    def _rebuild(self):
        self._step_fn = TL.make_train_step(self.model, self.cfg)

    def _restore(self):
        abstract = TL.abstract_state(self.model, self.cfg.optimizer)
        self.state, step = self.manager.restore(abstract, device=self.device)
        return step

    # -- the enforceable interface -------------------------------------------
    def train_step(self, batch) -> dict:
        self.state, metrics = self._step_fn(self.state,
                                            to_device(batch, self.device))
        self.step_idx += 1
        return {k: float(v) for k, v in metrics.items()}

    def checkpoint(self) -> dict:
        self.manager.save(self.step_idx, self.state)
        return self.manager.last_info() or {}

    def migrate(self, devices: Sequence) -> dict:
        """Stop-and-copy to another device list; returns timing breakdown."""
        t0 = time.perf_counter()
        info = self.checkpoint()
        t1 = time.perf_counter()
        self._release()
        self._place(devices)
        self._restore()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
