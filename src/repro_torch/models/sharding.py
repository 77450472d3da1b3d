"""Logical-axis sharding rules and the collectives that realise them on a
device mesh (the reference's `src/repro/models/sharding.py`).

Tensors are annotated with *logical* axes; `logical_to_pspec` maps them
onto the mesh's axes by `RULES`, dropping any mesh axis that does not
evenly divide the dimension, using no mesh axis twice, and unwrapping a
single axis to its bare name, exactly as the reference does. A
`PartitionSpec` here is a tuple with one entry per dimension: None, an
axis name, or a tuple of axis names (major to minor).

The reference hands the specs to GSPMD, which inserts the collectives.
The port runs SPMD by hand (Megatron-style): each process holds the
local shard of every tensor, and the model code moves data between
layouts at the reference's `constrain` points with explicit collectives
(`redistribute`). These are autograd functions whose backward is the
conjugate collective, so a loss computed from local shards back-
propagates into local gradients:

  - gather a dimension over an axis (all-gather; backward: take the
    local chunk, or reduce-scatter where the consumers' gradients are
    partial sums, a tensor-parallel block's input);
  - split a dimension over an axis (take the local chunk; backward:
    all-gather);
  - sum partial results over an axis (all-reduce, or reduce-scatter
    into a sharded dimension; backward: identity, or all-gather);
  - copy a replicated input into a tensor-parallel block (identity;
    backward: all-reduce, Megatron's ``f``).

`Mesh` wraps a ``torch.distributed.device_mesh.DeviceMesh`` with the
axis sizes, this process's coordinates and, for a step, the axes that
split its batch rows (`Mesh.for_batch`): over those axes the processes
hold distinct data, so the gradients of what they share are summed.
Every collective is recorded by `repro_torch.launch.collectives.COUNTER`
while it is on, with its mesh axis and the stride of its group in the
mesh's row-major rank order; a collective over one device is skipped.

`Mesh.abstract` is a mesh without a process group: the axis sizes, one
device's coordinates and an explicit device. It runs one device's share
of a step on one card (the dry run on the reference's 256- and
512-device meshes): every local shard has its real size, and each
collective issues nothing but returns what a real group would return in
shape and dtype (`all_gather` the local shard repeated, `reduce_scatter`
this coordinate's chunk, `all_reduce` a copy) and records itself as the
real one would. The values are finite but not the mesh's; the records
are exact, since no collective's size depends on values.
"""
from __future__ import annotations

import contextlib
import copy
import math
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.collectives import COUNTER

# logical axis -> tuple of mesh axes (in order of preference)
RULES: dict = {
    "batch": ("pod", "data"),   # data parallel (pod is pure-DP outer axis)
    "fsdp": ("data",),          # weight d_model dim: fully-sharded data parallel
    "tp": ("model",),           # tensor parallel: heads/ff/vocab/experts
    "expert": ("model",),       # expert parallel (MoE)
    "kv_seq": ("model",),       # decode KV-cache sequence dim (flash-decoding)
    "seq": (),                  # sequence: unsharded
    "sp": ("model",),           # Megatron-style sequence parallelism (residual
                                # stream between layers; gathered at attn/mlp)
    "layers": (),               # stacked-layer axis: never sharded
    None: (),
}

_TLS = threading.local()
_UNSET = object()
# the innermost `rules_ctx` of any thread, for threads that entered none:
# autograd's device worker threads, which run a CUDA backward (and a
# checkpointed block's recompute inside it) while the caller waits
_PROCESS = {"overrides": None}


@contextlib.contextmanager
def rules_ctx(overrides: Optional[dict]):
    """Remap logical axes for every spec computed inside (this thread,
    and the autograd threads that run its backward), e.g. {"tp": (),
    "fsdp": (), "batch": ("pod", "data", "model")} lays a model out pure
    data-parallel without touching model code."""
    prev = getattr(_TLS, "overrides", _UNSET)
    prev_process = _PROCESS["overrides"]
    _TLS.overrides = _PROCESS["overrides"] = (dict(overrides) if overrides
                                              else None)
    try:
        yield
    finally:
        _PROCESS["overrides"] = prev_process
        if prev is _UNSET:
            del _TLS.overrides
        else:
            _TLS.overrides = prev


def _ctx_overrides() -> Optional[dict]:
    own = getattr(_TLS, "overrides", _UNSET)
    return _PROCESS["overrides"] if own is _UNSET else own


class PartitionSpec(tuple):
    """One entry per dimension: None, a mesh axis, or a tuple of axes."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def spec_axes(entry) -> tuple:
    """The mesh axes of one PartitionSpec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_axes(mesh) -> dict:
    """{axis name: size} in mesh order, of a `Mesh`, a DeviceMesh, a
    `MeshConfig` or a mapping."""
    if isinstance(mesh, Mesh):
        return dict(mesh.sizes)
    if isinstance(mesh, dict):
        return dict(mesh)
    if hasattr(mesh, "mesh_dim_names"):                  # DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names(), mesh.shape()))    # MeshConfig


def logical_to_pspec(logical: Sequence, shape: Sequence[int], mesh,
                     overrides: Optional[dict] = None) -> PartitionSpec:
    """Map logical axes to a PartitionSpec valid for ``shape`` on ``mesh``."""
    rules = dict(RULES)
    ctx = _ctx_overrides()
    if ctx:
        rules.update(ctx)
    if overrides:
        rules.update(overrides)
    if len(logical) != len(shape):
        raise ValueError(f"logical axes {logical} do not match shape {shape}")
    sizes = mesh_axes(mesh)
    used: set = set()
    spec: list = []
    for name, dim in zip(logical, shape):
        axes = tuple(a for a in rules.get(name, ())
                     if a in sizes and a not in used)
        # drop trailing mesh axes until the shard product divides the dim
        while axes and not (dim > 0 and dim % math.prod(
                sizes[a] for a in axes) == 0):
            axes = axes[:-1]
        if axes:
            used.update(axes)
            spec.append(axes if len(axes) > 1 else axes[0])
        else:
            spec.append(None)
    return PartitionSpec(*spec)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def tree_pspecs(axes_tree, shape_tree, mesh):
    """Map a tree of logical-axes tuples + matching shapes -> PartitionSpecs."""
    if isinstance(axes_tree, dict):
        return {k: tree_pspecs(v, shape_tree[k], mesh)
                for k, v in axes_tree.items()}
    if not _is_axes(axes_tree):
        raise TypeError(f"not a logical-axes tuple: {axes_tree!r}")
    return logical_to_pspec(axes_tree, tuple(shape_tree), mesh)


def to_placements(pspec: Sequence, mesh) -> tuple:
    """The DeviceMesh placements of a PartitionSpec, one per mesh axis:
    ``Shard(dim)`` for the axis that shards tensor dimension ``dim``,
    ``Replicate()`` for an axis that shards none."""
    from torch.distributed.tensor import Replicate, Shard
    where = {a: d for d, entry in enumerate(pspec) for a in spec_axes(entry)}
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh_axes(mesh))


# ---------------------------------------------------------------------------
# The mesh a sharded computation runs on
# ---------------------------------------------------------------------------

class Mesh:
    """A DeviceMesh with its axis sizes, this process's coordinates (None
    on a process outside the mesh) and `batch`: the mesh axes that split
    the batch rows of the step being run (`for_batch`)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.names = tuple(device_mesh.mesh_dim_names)
        self.sizes = dict(zip(self.names, device_mesh.shape))
        coord = device_mesh.get_coordinate()
        self.coords = None if coord is None else dict(zip(self.names, coord))
        self.batch: tuple = ()
        self._device = None

    @classmethod
    def abstract(cls, sizes: dict, coords: Optional[dict] = None,
                 device="cuda") -> "Mesh":
        """A mesh of axis `sizes` (name -> size, in mesh order) without a
        process group: one device's share at `coords` (default every
        axis 0) on `device`. Its collectives issue nothing (see the
        module docstring); `group` raises."""
        from repro_torch.device import resolve_device
        out = cls.__new__(cls)
        out.device_mesh = None
        out.names = tuple(sizes)
        out.sizes = {a: int(n) for a, n in sizes.items()}
        out.coords = {a: int((coords or {}).get(a, 0)) for a in out.names}
        for a, i in out.coords.items():
            if not 0 <= i < out.sizes[a]:
                raise ValueError(f"coordinate {a}={i} is outside the axis "
                                 f"of {out.sizes[a]}")
        out.batch = ()
        out._device = resolve_device(device)
        return out

    @property
    def is_abstract(self) -> bool:
        return self.device_mesh is None

    @property
    def device_type(self) -> str:
        if self.is_abstract:
            return self._device.type
        return self.device_mesh.device_type

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes.values())

    @property
    def member(self) -> bool:
        return self.coords is not None

    @property
    def device(self) -> torch.device:
        if self.is_abstract:
            return self._device
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords[axis] if axis in self.sizes else 0

    def stride(self, axis: str) -> int:
        """The rank distance between neighbours along `axis` in the
        mesh's row-major rank order: the product of the later axes."""
        names = self.names
        return math.prod(self.sizes[a] for a in names[names.index(axis) + 1:])

    def group(self, axis: str):
        if self.is_abstract:
            raise RuntimeError("an abstract mesh has no process group")
        return self.device_mesh.get_group(axis)

    def for_batch(self, shape: Sequence[int]) -> "Mesh":
        """This mesh with `batch` the axes that split an input of global
        shape ``shape`` = (batch, seq, ...) under the rules."""
        axes = ("batch", "seq") + (None,) * (len(shape) - 2)
        out = copy.copy(self)
        out.batch = spec_axes(logical_to_pspec(axes[:len(shape)], shape,
                                               self)[0])
        return out

    def pspec(self, logical: Sequence, shape: Sequence[int]) -> PartitionSpec:
        return logical_to_pspec(logical, shape, self)

    def __repr__(self):
        kind = "abstract " if self.is_abstract else ""
        return f"{kind}Mesh({self.sizes}, batch={self.batch})"


# ---------------------------------------------------------------------------
# Collectives on local shards (each recorded while COUNTER is on)
# ---------------------------------------------------------------------------

_AG = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_RS = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _record(kind: str, t: torch.Tensor, n: int, axis=None, stride=0):
    if COUNTER.enabled:
        COUNTER.record(kind, t.numel() * t.element_size(), n, axis, stride)


def all_gather(x: torch.Tensor, dim: int, mesh: Mesh, axis: str):
    """Concatenate the axis's shards of dimension `dim`, in axis order
    (on an abstract mesh, the local shard n times)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    if mesh.is_abstract:
        out = xt.repeat((n,) + (1,) * (xt.dim() - 1))
    else:
        out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
        _AG(out, xt, group=mesh.group(axis))
    _record("all-gather", out, n, axis, mesh.stride(axis))
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, mesh: Mesh, axis: str):
    """Sum over the axis, keeping this process's chunk of `dim` (on an
    abstract mesh, the chunk of `x` itself)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    size = xt.shape[0] // n
    if mesh.is_abstract:
        out = xt[mesh.index(axis) * size:(mesh.index(axis) + 1) * size]
        out = out.contiguous()
    else:
        out = xt.new_empty((size,) + tuple(xt.shape[1:]))
        _RS(out, xt, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    _record("reduce-scatter", out, n, axis, mesh.stride(axis))
    return out.movedim(0, dim).contiguous()


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, op=None):
    """Sum (or `op`) over the axis; `x` is left as it is (on an abstract
    mesh, a copy of `x`)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    out = x.contiguous().clone()
    if not mesh.is_abstract:
        dist.all_reduce(out, op=op or dist.ReduceOp.SUM,
                        group=mesh.group(axis))
    _record("all-reduce", out, n, axis, mesh.stride(axis))
    return out


def local_chunk(x: torch.Tensor, dim: int, mesh: Mesh, axis: str):
    """This process's chunk of dimension `dim` over the axis."""
    n = mesh.size(axis)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * size, size).contiguous()


def _axis(step) -> str:
    """The mesh axis of a step: ("gather" | "split" | "rs", dim, axis,
    ...) or ("ar" | "copy", axis)."""
    return step[2] if step[0] in ("gather", "split", "rs") else step[1]


def _apply(step, x, mesh):
    kind = step[0]
    if kind == "gather":
        return all_gather(x, step[1], mesh, step[2])
    if kind == "split":
        return local_chunk(x, step[1], mesh, step[2])
    if kind == "rs":
        return reduce_scatter(x, step[1], mesh, step[2])
    if kind == "ar":
        return all_reduce(x, mesh, step[1])
    return x                                             # "copy"


def _inverse(step):
    """The step the backward takes for `step`."""
    kind = step[0]
    if kind == "gather":          # ("gather", dim, axis, grad: "rs" | "split")
        return (step[3], step[1], step[2])
    if kind in ("split", "rs"):
        return ("gather", step[1], step[2])
    if kind == "copy":
        return ("ar", step[1])
    return ("copy", step[1])                             # "ar"


class _Steps(torch.autograd.Function):
    """Cast to `dtype`, then run `steps` forward; the backward casts the
    gradient back to the input's dtype first (so gradients are reduced in
    the master dtype) and runs the inverse steps in reverse order."""

    @staticmethod
    def forward(ctx, x, steps, mesh, dtype):
        ctx.steps, ctx.mesh, ctx.in_dtype = steps, mesh, x.dtype
        out = x.to(dtype)
        for step in steps:
            out = _apply(step, out, mesh)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.in_dtype)
        for step in reversed(ctx.steps):
            g = _apply(_inverse(step), g, ctx.mesh)
        return g, None, None, None


def _plan(src: Sequence, dst: Sequence, mesh: Mesh, partial=(),
          grad_partial=()) -> tuple:
    """The steps that move a local tensor from layout `src` to `dst`
    (PartitionSpecs of one global shape)."""
    steps = []
    for d, (s_entry, d_entry) in enumerate(zip(src, dst)):
        s_axes, d_axes = spec_axes(s_entry), spec_axes(d_entry)
        keep = 0
        while (keep < min(len(s_axes), len(d_axes))
               and s_axes[keep] == d_axes[keep]):
            keep += 1
        for a in reversed(s_axes[keep:]):                # minor first
            if a in partial:
                raise ValueError(f"axis {a} is both partial and sharded")
            steps.append(("gather", d, a,
                          "rs" if a in grad_partial else "split"))
        for a in d_axes[keep:]:                          # major first
            steps.append(("rs", d, a) if a in partial else ("split", d, a))
    where_src = {a: d for d, e in enumerate(src) for a in spec_axes(e)}
    where_dst = {a: d for d, e in enumerate(dst) for a in spec_axes(e)}
    for a in where_src.keys() & where_dst.keys():
        if where_src[a] != where_dst[a]:
            raise ValueError(f"moving axis {a} between dimensions ({src} -> "
                             f"{dst}) needs an all-to-all, which is not "
                             f"ported")
    for a in mesh.names:
        if a in partial and a not in where_dst:
            steps.append(("ar", a))
        elif (a in grad_partial and a not in where_src
              and a not in where_dst):
            steps.append(("copy", a))
    return tuple(s for s in steps if mesh.size(_axis(s)) > 1)


def redistribute(x: torch.Tensor, src: Sequence, dst: Sequence, mesh: Mesh,
                 *, partial=(), grad_partial=(), dtype=None) -> torch.Tensor:
    """Move local tensor `x` from PartitionSpec `src` to `dst` (cast to
    `dtype` first, if given). `partial`: axes over which `x` holds
    partial sums, summed on the way. `grad_partial`: axes over which the
    gradient arriving at the result is a partial sum (the consumer is a
    tensor-parallel block, or its data differ between the axis's
    processes), summed in the backward."""
    steps = _plan(src, dst, mesh, partial, grad_partial)
    dtype = dtype or x.dtype
    if not steps and dtype == x.dtype:
        return x
    return _Steps.apply(x, steps, mesh, dtype)


def use_weight(t: torch.Tensor, spec: Sequence, mesh: Mesh, keep=(),
               grad_partial=(), dtype=None) -> torch.Tensor:
    """A weight's local shard (PartitionSpec `spec`) as a layer uses it:
    gathered over every mesh axis of `spec` but those in `keep`, cast to
    `dtype` first; `grad_partial` are the axes over which its gradient is
    a partial sum (`redistribute`'s)."""
    dst = tuple(tuple(a for a in spec_axes(e) if a in keep) or None
                for e in spec)
    dst = tuple(e[0] if e is not None and len(e) == 1 else e for e in dst)
    return redistribute(t, spec, dst, mesh, grad_partial=grad_partial,
                        dtype=dtype)


def constrain(x: torch.Tensor, logical: Sequence, mesh: Optional[Mesh] = None,
              *, src: Sequence = (), shape: Sequence[int] = (), partial=(),
              grad_partial=()) -> torch.Tensor:
    """Put `x` in the layout the rules give the logical axes `logical`;
    a no-op outside a mesh. On a mesh, `x` is a local shard laid out as
    the logical axes `src`, of global shape `shape`; `partial` and
    `grad_partial` are `redistribute`'s."""
    if mesh is None:
        return x
    return redistribute(x, logical_to_pspec(src, shape, mesh),
                        logical_to_pspec(logical, shape, mesh), mesh,
                        partial=partial, grad_partial=grad_partial)


# ---------------------------------------------------------------------------
# Whole tensors <-> local shards
# ---------------------------------------------------------------------------

def shard_range(entry, n: int, mesh: Mesh) -> tuple:
    """(start, size) of this process's chunk of a dimension of size `n`
    laid out as PartitionSpec entry `entry`."""
    axes = spec_axes(entry)
    idx = 0
    for a in axes:
        idx = idx * mesh.size(a) + mesh.index(a)
    size = n // math.prod(mesh.size(a) for a in axes)
    return idx * size, size


def _local_view(full: torch.Tensor, pspec: Sequence, mesh: Mesh):
    """The view of `full` that is this process's shard under `pspec`."""
    out = full
    for d, entry in enumerate(pspec):
        if spec_axes(entry):
            out = out.narrow(d, *shard_range(entry, full.shape[d], mesh))
    return out


def gather_tensor(local: torch.Tensor, pspec: Sequence, mesh: Mesh):
    """The full tensor of a local shard under `pspec` (collective over
    the mesh)."""
    out = local
    for d, entry in enumerate(pspec):
        for a in reversed(spec_axes(entry)):
            out = all_gather(out, d, mesh, a)
    return out


def whole_leaf_stats(values: Sequence, shardings: Sequence, op: str):
    """Per-leaf statistics of local shards -> the statistics of the whole
    leaves, equal on every process of the mesh. `values`: one 0-d
    tensor per leaf (this process's sum or max over its shard);
    `shardings`: the leaves' `NamedSharding`s; `op` "sum" or "max". A
    sum counts each distinct shard once: a process adds its value only if
    it is the first replica along every axis that does not shard the
    leaf."""
    mesh = shardings[0].mesh
    vec = torch.stack([v.reshape(()) for v in values])
    if op == "sum":
        first = [all(mesh.index(a) == 0 for a in mesh.names
                     if a not in {x for e in sh.spec for x in spec_axes(e)})
                 for sh in shardings]
        vec = torch.where(torch.tensor(first, device=vec.device), vec, 0.0)
        red = dist.ReduceOp.SUM
    elif op == "max":
        red = dist.ReduceOp.MAX
    else:
        raise ValueError(f"unknown statistic {op!r}")
    for a in mesh.names:
        vec = all_reduce(vec, mesh, a, red)
    return list(vec.unbind(0))


class NamedSharding:
    """A PartitionSpec on a mesh (the reference's
    ``jax.sharding.NamedSharding``): where each process's shard of a
    tensor lies."""

    def __init__(self, mesh: Mesh, spec: Sequence):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This process's shard of `full` (a copy on the mesh's device)."""
        view = _local_view(full, self.spec, self.mesh)
        return view.to(self.mesh.device, copy=True,
                       memory_format=torch.contiguous_format)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        return gather_tensor(local, self.spec, self.mesh)

    def __repr__(self):
        return f"NamedSharding({self.mesh.sizes}, {self.spec})"
