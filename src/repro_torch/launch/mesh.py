"""Mesh construction (the reference's `src/repro/launch/mesh.py`), over
``torch.distributed.device_mesh``.

One process drives one device. The caller starts the processes
(``torchrun``, or ``torch.multiprocessing`` with the "spawn" start
method) and calls ``torch.distributed.init_process_group`` with the
address, world size and rank; the meshes are built over those ranks,
with the reference's axis names and order. The device type is
explicit: "cuda" (NCCL, rank r on card r of its host) by default, "cpu"
(gloo) when the caller asks, as the tests do.

`make_production_mesh` and `make_abstract_mesh` build abstract meshes
(`sharding.Mesh.abstract`): the reference's 16x16 and 2x16x16 meshes
(or any shape) as one device's share on one card, with no process
group, for the dry run and the hill-climber. Only these two calls build
one; `make_mesh` and `make_local_mesh` always build a real mesh over
the process group. Importing this module touches no device and no
process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig
from repro_torch.device import resolve_device
from repro_torch.models.sharding import Mesh

# Production topology of the reference: one v5e pod = 16x16 = 256 chips;
# multi-pod = 2 pods.
SINGLE_POD = MeshConfig(data=16, model=16, pod=1)
MULTI_POD = MeshConfig(data=16, model=16, pod=2)


def make_abstract_mesh(cfg, names=None, device="cuda",
                       coords=None) -> Mesh:
    """An abstract mesh (one device's share, no process group) of a
    `MeshConfig`, or of a shape tuple with its axis `names`; `coords`
    the device's coordinates (default all 0)."""
    if isinstance(cfg, MeshConfig):
        shape, names = cfg.shape(), cfg.axis_names()
    else:
        shape = tuple(cfg)
        if names is None or len(names) != len(shape):
            raise ValueError(f"mesh shape {shape} needs one name an axis, "
                             f"got {names}")
    return Mesh.abstract(dict(zip(names, shape)), coords, device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         coords=None) -> Mesh:
    """The reference's production mesh as an abstract mesh: 16x16
    ("data", "model"), or 2x16x16 ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, names, device, coords)


def mesh_of_ranks(device_type: str, ranks, names) -> Mesh:
    """A `Mesh` over `ranks` (a nested list shaped as the mesh), built by
    every process of the process group (ranks outside it included: they
    get a mesh with no coordinates)."""
    from torch.distributed.device_mesh import DeviceMesh
    resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed's process group: "
                           "call init_process_group first")
    return Mesh(DeviceMesh(device_type, torch.as_tensor(ranks),
                           mesh_dim_names=tuple(names)))


def make_mesh(cfg: MeshConfig, device_type: str = "cuda") -> Mesh:
    """The mesh of `cfg` over every rank of the process group; raises if
    the world size is not the mesh's size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != cfg.n_devices:
        raise ValueError(f"mesh {dict(zip(cfg.axis_names(), cfg.shape()))} "
                         f"needs {cfg.n_devices} processes; the process "
                         f"group has {world}")
    ranks = torch.arange(cfg.n_devices).reshape(cfg.shape())
    return mesh_of_ranks(device_type, ranks, cfg.axis_names())


def make_local_mesh(data: int = 0, model: int = 1,
                    device_type: str = "cuda") -> Mesh:
    """(data, model) mesh over every rank of the process group; ``data``
    0 takes what ``model`` leaves."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data == 0:
        data = world // model
    return make_mesh(MeshConfig(data=data, model=model), device_type)


def describe(mesh: Mesh) -> dict:
    return {"axes": dict(mesh.sizes), "devices": mesh.n_devices}
