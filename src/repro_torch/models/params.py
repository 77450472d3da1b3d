"""ParamSpec trees: one declaration drives init, abstract shapes and
parameter counts.

Each module declares its parameters as a nested dict of ``ParamSpec``
leaves, as in the reference. `init_params` draws the reference's
distributions (zeros, ones, normal·scale, normal/√fan_in, Mamba-2's
``ssm_a`` = log U[1, 16) and RG-LRU's ``lru_lambda`` =
log(expm1(−log U[0.9, 0.999) / 8))) with one ``torch.Generator`` per
leaf, seeded from the caller's seed and the same crc32 salt of the
leaf's path ("layers/attn/wq"). It cannot reproduce JAX's random
stream and does not try: parity tests carry the reference's arrays
across (`repro_torch.convert.from_reference_params`).

On a mesh, `param_pspecs` and `param_shardings` give each leaf's
PartitionSpec and placement from its logical axes; `shard_tree` places
a tree of full tensors (each process keeps exactly its shard) and
`gather_tree` is its inverse, for a checkpoint. `init_local` draws one
device's shards directly at their shapes (the whole tree never exists),
as an abstract mesh's dry run needs, and `local_bytes` counts a tree's
bytes on one device of a mesh without allocating anything.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device
from repro_torch.models.sharding import (NamedSharding, logical_to_pspec,
                                         mesh_axes, spec_axes)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                    # logical axes, len == len(shape)
    init: str = "normal"           # normal | zeros | ones | scaled
    scale: float = 0.02
    dtype: str = "float32"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten(tree, prefix=""):
    """[(path, leaf)] of a nested dict, paths as "a/b/c", keys sorted as
    JAX flattens a dict."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def stack_specs(n: int, tree):
    """Prepend a 'layers' axis of size n to every spec in the tree."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(n,) + s.shape, axes=("layers",) + s.axes), tree)


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dev,
               shape=None) -> torch.Tensor:
    """A leaf drawn at `shape` (default the spec's; a shard's shape on a
    mesh), its fan-in the whole leaf's."""
    dtype = DTYPES[spec.dtype]
    shape = tuple(spec.shape if shape is None else shape)
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if spec.init == "ssm_a":  # Mamba-2 A_log: log uniform [1, 16)
        u = torch.rand(shape, **f32) * 15.0 + 1.0
        return torch.log(u).to(dtype)
    if spec.init == "lru_lambda":  # RG-LRU: a^c ~ uniform [0.9, 0.999)
        u = torch.rand(shape, **f32) * (0.999 - 0.9) + 0.9
        sp = -torch.log(u) / 8.0           # softplus(lambda), with c = 8
        return torch.log(torch.expm1(sp)).to(dtype)
    # scaled in place: no transient second copy of a leaf (Mamba-2's
    # stacked in_proj is 6.9 GB in float32)
    if spec.init == "scaled":  # normal / sqrt(fan_in); fan_in = shape[-2]
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return torch.randn(shape, **f32).div_(math.sqrt(fan_in)).to(dtype)
    if spec.init == "normal":
        return torch.randn(shape, **f32).mul_(spec.scale).to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def _seed_of(generator) -> int:
    if isinstance(generator, torch.Generator):
        return generator.initial_seed()
    return int(generator or 0)


def _leaf_seed(seed: int, path: str) -> int:
    salt = zlib.crc32(path.encode()) % (2**31)
    return ((seed % 2**32) << 31) | salt


def init_params(spec_tree, generator=None, device="cuda"):
    """Materialize a ParamSpec tree on `device`. `generator` is a
    ``torch.Generator`` or an int seed (default 0); each leaf draws from
    its own generator seeded by (seed, crc32 of its path)."""
    dev = resolve_device(device)
    seed = _seed_of(generator)
    leaves = {}
    for path, spec in flatten(spec_tree):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_leaf_seed(seed, path))
        leaves[path] = _init_leaf(spec, gen, dev)
    return unflatten(spec_tree, leaves)


def local_shape(shape, pspec, mesh) -> tuple:
    """A leaf's shard shape on one device of `mesh` under `pspec`."""
    return tuple(n // math.prod(mesh_axes(mesh)[a] for a in spec_axes(e))
                 for n, e in zip(shape, pspec))


def init_local(spec_tree, mesh, generator=None, overrides=None):
    """This device's shard of every leaf of a ParamSpec tree on `mesh`
    (its `Mesh.device`), drawn at the shard's shape from a generator
    seeded by (seed, the leaf's path, the shard's index over the axes
    that split the leaf): the whole leaves are never made, and replicas
    of a shard draw the same values. The values are not the whole
    leaf's shards (`init_params` then `shard_tree`); an abstract mesh's
    dry run needs only their shapes, dtypes and distributions."""
    seed = _seed_of(generator)
    leaves = {}
    for path, spec in flatten(spec_tree):
        pspec = logical_to_pspec(spec.axes, spec.shape, mesh, overrides)
        split = {a for e in pspec for a in spec_axes(e)}
        idx = 0
        for a in mesh.names:
            if a in split:
                idx = idx * mesh.size(a) + mesh.index(a)
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed((_leaf_seed(seed, path)
                         ^ (idx * 0x9E3779B97F4A7C15)) % 2**63)
        leaves[path] = _init_leaf(spec, gen, mesh.device,
                                  local_shape(spec.shape, pspec, mesh))
    return unflatten(spec_tree, leaves)


def local_bytes(spec_tree, mesh, overrides=None) -> int:
    """The bytes of one device's shards of a ParamSpec tree on `mesh`
    (a `Mesh`, `MeshConfig` or {axis: size}): each leaf's numel over the
    product of the mesh axes in its PartitionSpec, times its element
    size. Nothing is allocated."""
    total = 0
    for _, spec in flatten(spec_tree):
        pspec = logical_to_pspec(spec.axes, spec.shape, mesh, overrides)
        numel = math.prod(local_shape(spec.shape, pspec, mesh))
        total += numel * DTYPES[spec.dtype].itemsize
    return total


def unflatten(tree, leaves: dict, prefix=""):
    """A nested dict shaped as `tree` holding ``leaves[path]``."""
    if not isinstance(tree, dict):
        return leaves[prefix]
    return {k: unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree.items()}


def abstract_params(spec_tree):
    """The tree's shapes and dtypes as tensors on the ``meta`` device:
    nothing is allocated (the reference's ShapeDtypeStructs)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=DTYPES[s.dtype],
                                          device="meta"), spec_tree)


def param_count_tree(spec_tree) -> int:
    return sum(math.prod(s.shape) for _, s in flatten(spec_tree))


def param_pspecs(spec_tree, mesh, overrides=None):
    return tree_map(lambda s: logical_to_pspec(s.axes, s.shape, mesh,
                                               overrides), spec_tree)


def param_shardings(spec_tree, mesh, overrides=None):
    return tree_map(lambda s: NamedSharding(
        mesh, logical_to_pspec(s.axes, s.shape, mesh, overrides)), spec_tree)


def shard_tree(tree, shardings):
    """Each leaf's local shard under the matching `NamedSharding` (a
    copy on the mesh's device): the full tree placed onto the mesh."""
    sh = dict(flatten(shardings))
    return unflatten(tree, {p: sh[p].shard(t) for p, t in flatten(tree)})


def gather_tree(tree, shardings):
    """The full tensors of a tree of local shards (collective over the
    mesh): `shard_tree`'s inverse."""
    sh = dict(flatten(shardings))
    return unflatten(tree, {p: sh[p].gather(t) for p, t in flatten(tree)})
