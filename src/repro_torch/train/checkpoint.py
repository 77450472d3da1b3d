"""Checkpoints with restore onto a target device (the migration
substrate; the reference's `src/repro/train/checkpoint.py`).

The on-disk format is the reference's, so either package reads the
other's checkpoints: one ``state.npz`` keyed by leaf path
(``params/layers/attn/wq``, ``opt/m/...``, ``step``), bfloat16 leaves
stored as their raw uint16 bits (``np.savez`` has no bfloat16), and a
``manifest.json`` (step, each key's shape and stored dtype, total bytes,
extra). Writes are atomic (tmp + rename). `load` puts every leaf on the
target device or, given ``shardings`` (a tree of `NamedSharding`s of
the *target* mesh), each process's shard of it on the mesh: restoring
onto another mesh is the reshard, bit for bit. `save` of a state held
as shards on a mesh (``shardings`` its placement) gathers the full
arrays once, a collective over the mesh, and one process (the mesh's
first) writes them; the caller synchronises the processes before any
reads the checkpoint. `CheckpointManager` keeps a bounded history, a
latest pointer for crash recovery, and writes on a background thread
after a synchronous host snapshot.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import flatten, gather_tree, unflatten

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.int64: np.int64, torch.float64: np.float64}


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host array, bfloat16 as its raw uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _writes(shardings) -> bool:
    """Whether this process writes a checkpoint of a state placed by
    `shardings` (None: one device, it does): the mesh's first does."""
    if shardings is None:
        return True
    mesh = flatten(shardings)[0][1].mesh
    return all(i == 0 for i in mesh.coords.values())


def _host_tree(state: Any, shardings=None) -> dict:
    """{path: host array} of `state`; on a mesh gathered from its shards
    (a collective) and kept by the writer only (empty elsewhere)."""
    if shardings is not None:
        state = gather_tree(state, shardings)
        if not _writes(shardings):
            return {}
    return {k: _to_host(v) for k, v in flatten(state)}


def save(path: str, state: Any, *, step: int = 0,
         extra: Optional[dict] = None, shardings=None) -> dict:
    """Write `state` (nested dicts of tensors or arrays) to the directory
    `path`; on a mesh (``shardings``) every process calls it and the
    mesh's first writes. Returns timing info and the bytes written (0 on
    a process that does not write)."""
    t0 = time.perf_counter()
    host = _host_tree(state, shardings)
    t_gather = time.perf_counter() - t0
    if not _writes(shardings):
        return {"gather_s": t_gather, "write_s": 0.0, "total_s": t_gather,
                "bytes": 0}
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, ".tmp.npz")
    np.savez(tmp, **host)
    os.replace(tmp, os.path.join(path, "state.npz"))
    manifest = {
        "step": int(step),
        "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                 for k, v in host.items()},
        "bytes": int(sum(v.nbytes for v in host.values())),
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    t_total = time.perf_counter() - t0
    return {"gather_s": t_gather, "write_s": t_total - t_gather,
            "total_s": t_total, "bytes": manifest["bytes"]}


def load(path: str, abstract_state: Any, device="cuda",
         shardings=None) -> Any:
    """Restore a state shaped as `abstract_state` (nested dicts whose
    leaves have ``.shape`` and a torch ``.dtype``, e.g. meta tensors from
    `loop.abstract_state`) onto `device`, or with `shardings` (the target
    mesh's placement of the same tree) each process's shards onto the
    mesh. Raises on a missing leaf or a shape that differs."""
    dev = resolve_device(device) if shardings is None else None
    sh = dict(flatten(shardings)) if shardings is not None else {}
    with np.load(os.path.join(path, "state.npz")) as z:
        data = {k: z[k] for k in z.files}
    leaves = {}
    for key, leaf in flatten(abstract_state):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(leaf.shape)}")
        if leaf.dtype == torch.bfloat16 and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)            # stored as raw bits
        elif leaf.dtype == torch.bfloat16:
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.astype(_NP_DTYPES[leaf.dtype]))
        leaves[key] = sh[key].shard(t) if sh else t.to(dev)
    return unflatten(abstract_state, leaves)


def manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


class CheckpointManager:
    """Bounded checkpoint history + async saves + latest-pointer recovery."""

    def __init__(self, root: str, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._last_info: Optional[dict] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def all_steps(self) -> list:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.root, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        """Join an in-flight async save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def last_info(self) -> Optional[dict]:
        """Info dict of the most recent completed save (waits for an
        in-flight async save first)."""
        self.wait()
        return self._last_info

    def save(self, step: int, state: Any, extra: Optional[dict] = None,
             shardings=None) -> Optional[dict]:
        """Write a checkpoint; returns its info dict for synchronous saves
        (async saves return None: use `last_info()`). On a mesh
        (``shardings``) every process calls it; the state is gathered
        synchronously and the mesh's first process writes."""
        self.wait()
        # snapshot to the host synchronously (cheap vs the write), write async
        host = _host_tree(state, shardings)      # {path: array}, flat
        writes = _writes(shardings)

        def work():
            try:
                if not writes:
                    self._last_info = {"bytes": 0}
                    return
                self._last_info = save(self.step_dir(step), host, step=step,
                                       extra=extra)
                self._gc()
            except Exception as e:  # re-raised in the caller by wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
            return None
        work()
        self.wait()
        return self._last_info

    def restore(self, abstract_state: Any, *, step: Optional[int] = None,
                device="cuda", shardings=None) -> tuple:
        """(state, step) of checkpoint `step` (default the latest), onto
        `device` or, with `shardings`, onto the target mesh."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return load(self.step_dir(step), abstract_state, device,
                    shardings), step

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
