"""The programs that `tests/test_torch_mesh.py` runs in its spawned
processes, one process a rank of a gloo process group on the CPU.

This module imports torch, numpy and the port only (never JAX or the
reference package), so a rank never loads them. The test process writes
the inputs (the reference's states and the batches) as ``.npz`` files
into the job's directory; the ranks write what they computed, gathered
to full tensors by rank 0, beside them, and the test process holds those
against the reference.
"""
import dataclasses
import datetime
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig, OptimizerConfig, TrainConfig
from repro_torch.configs import get_arch
from repro_torch.core.elastic import ElasticJob, mesh_over
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import collectives as COLL
from repro_torch.launch.mesh import describe, make_local_mesh, make_mesh
from repro_torch.models import sharding as SH
from repro_torch.models.api import get_model
from repro_torch.models.params import (flatten, gather_tree, param_shardings,
                                       shard_tree, unflatten)
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import loop as TL

SEQ, BATCH, MICRO = 16, 8, 4
TRAINER_STEPS = 8       # two migrations: 4 -> 2 ranks, then 2 -> 1


def model_cfg(heads=(4, 2)):
    """The narrow dense config of the mesh tests: SmolLM's smoke config
    (2 layers, d 64, vocab 256) in float32, with `heads` (query, key)
    heads of 16."""
    return dataclasses.replace(get_arch("smollm-135m").smoke,
                               dtype="float32", n_heads=heads[0],
                               n_kv_heads=heads[1], head_dim=16)


def opt_kw(compression="none"):
    return dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5,
                compression=compression)


def train_kw():
    return dict(seq_len=SEQ, global_batch=BATCH, microbatch=MICRO)


def run(rank, world, job, store, out_dir):
    """Entry of every spawned process (`torch.multiprocessing`)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        assert not {"jax", "repro"} & set(sys.modules), "a rank imported JAX"
        JOBS[job](rank, Path(out_dir))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _load(path):
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}


def _state(model, opt, flat):
    """A full train state from {path: tensor}."""
    tree = TL.abstract_state(model, opt)
    return unflatten(tree, {p: flat[p].to(t.dtype) for p, t in flatten(tree)})


def _batches(out):
    z = _load(out / "batches.npz")
    return [{"tokens": z[f"tokens{i}"].numpy(), "labels": z[f"labels{i}"]
             .numpy()} for i in range(len(z) // 2)]


def _save(rank, path, tree, meta=None):
    if rank == 0:
        np.savez(path, **{p: t.detach().cpu().numpy()
                          for p, t in flatten(tree)})
        if meta is not None:
            path.with_suffix(".json").write_text(json.dumps(meta))


def _mesh(shape):
    if shape == "1x2":
        return mesh_over([0, 1], model_axis=2)
    if shape == "one":
        return mesh_over([0])
    data, model = (int(x) for x in shape.split("x"))
    return make_mesh(MeshConfig(data=data, model=model), "cpu")


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _steps(rank, out, mesh, shape, model, state0="state0"):
    """Three train steps from the state in `state0`.npz; each step's
    metrics; the final state gathered."""
    opt = OptimizerConfig(**opt_kw())
    step = TL.make_train_step(model, TrainConfig(**train_kw(),
                                                 optimizer=opt), mesh)
    sh = TL.state_shardings(model, opt, mesh)
    state = shard_tree(_state(model, opt, _load(out / f"{state0}.npz")), sh)
    metrics = []
    for batch in _batches(out):
        state, m = step(state, batch)
        metrics.append(_floats(m))
    _save(rank, out / f"steps_{shape}.npz", gather_tree(state, sh), metrics)
    return state


def _grads(rank, out, mesh, shape, model):
    """Loss and gradients at state0 on the first batch (no microbatches)."""
    params = _state(model, OptimizerConfig(), _load(out / "state0.npz"))[
        "params"]
    sh = param_shardings(model.specs(), mesh)
    leaves = TL._grad_leaves(shard_tree(params, sh))
    run_mesh = mesh.for_batch((BATCH, SEQ))
    batch = shard_batch(_batches(out)[0], run_mesh)
    loss, metrics = TL._backward(model, "none", leaves, batch, run_mesh)
    _save(rank, out / f"grads_{shape}.npz",
          gather_tree(TL._grads(leaves), sh),
          {"loss": float(loss), **_floats(metrics)})


def _int8(rank, out, mesh, model):
    """int8 steps one at a time from the reference's state of each step."""
    opt = OptimizerConfig(**opt_kw("int8"))
    step = TL.make_train_step(model, TrainConfig(**train_kw(),
                                                 optimizer=opt), mesh)
    sh = TL.state_shardings(model, opt, mesh)
    for i, batch in enumerate(_batches(out)):
        state = shard_tree(_state(model, opt, _load(out / f"int8_state{i}.npz")),
                           sh)
        state, m = step(state, batch)
        _save(rank, out / f"int8_{i}.npz", gather_tree(state, sh),
              _floats(m))


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def _spy():
    """Record every collective at the torch.distributed boundary, apart
    from the counter: (kind, result bytes, group size)."""
    seen = []

    def wrap(fn, kind):
        def call(out, *args, group=None, **kw):
            seen.append((kind, out.numel() * out.element_size(),
                         dist.get_world_size(group)))
            return fn(out, *args, group=group, **kw)
        return call
    SH._AG = wrap(SH._AG, "all-gather")
    SH._RS = wrap(SH._RS, "reduce-scatter")
    real_ar = dist.all_reduce

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        seen.append(("all-reduce", t.numel() * t.element_size(),
                     dist.get_world_size(group)))
        return real_ar(t, op=op, group=group, async_op=async_op)
    dist.all_reduce = all_reduce
    return seen


def _collectives(rank, out, model):
    """One counted step on each mesh: the counter's records and summary,
    the spy's records, and the roofline's collective seconds."""
    from repro_torch.launch.roofline import collective_seconds
    seen = _spy()
    report = {}
    for shape in ("2x2", "4x1", "1x2", "one"):
        mesh = _mesh(shape)
        if not mesh.member:
            continue
        opt = OptimizerConfig(**opt_kw())
        step = TL.make_train_step(model, TrainConfig(**train_kw(),
                                                     optimizer=opt), mesh)
        state = TL.init_state(model, opt, 0, mesh=mesh)
        COLL.COUNTER.reset()
        seen.clear()
        with COLL.COUNTER.on():
            step(state, _batches(out)[0])
        summary = COLL.COUNTER.summary()
        report[shape] = {
            "records": COLL.COUNTER.records, "seen": list(seen),
            "summary": summary,
            "collective_s": collective_seconds(summary["total_wire_bytes"],
                                               mesh.n_devices)}
    if rank in (0, 1):
        (out / f"collectives_r{rank}.json").write_text(json.dumps(report))


def _shard_batch(rank, out):
    """Each rank's slice of the global batch on (2, 2) and (4, 1)."""
    for shape in ("2x2", "4x1"):
        mesh = _mesh(shape)
        local = shard_batch(_batches(out)[0], mesh)
        np.savez(out / f"batch_{shape}_r{rank}.npz",
                 **{k: v.numpy() for k, v in local.items()},
                 coords=np.array([mesh.index("data"), mesh.index("model")]))


def _reshard(rank, out, model, state, mesh):
    """A checkpoint of `state` (on `mesh`) restored onto (4, 1), (1, 2),
    one rank on a (1, 1) mesh and one rank without a mesh; each restored
    state gathered."""
    opt = OptimizerConfig(**opt_kw())
    mgr = CKPT.CheckpointManager(str(out / "ckpt"), keep=2, async_save=False)
    mgr.save(3, state, shardings=TL.state_shardings(model, opt, mesh))
    dist.barrier()
    abstract = TL.abstract_state(model, opt)
    for target in ("4x1", "1x2", "one"):
        tmesh = _mesh(target)
        if tmesh.member:
            sh = TL.state_shardings(model, opt, tmesh)
            restored, step = mgr.restore(abstract, shardings=sh)
            _save(rank, out / f"restore_{target}.npz",
                  gather_tree(restored, sh), {"step": step})
    if rank == 0:
        restored, _ = mgr.restore(abstract, device="cpu")
        _save(rank, out / "restore_plain.npz", restored)
    dist.barrier()


def _elastic(rank, out, model):
    """ElasticJob on ranks 0-3 -> 0-1 -> 0-3, one step on each, the state
    gathered before and after each migration; and an unmigrated twin."""
    opt = OptimizerConfig(**opt_kw())
    cfg = TrainConfig(**train_kw(), optimizer=opt)
    batches = _batches(out)
    job = ElasticJob(model, cfg, str(out / "elastic"))
    twin = ElasticJob(model, cfg, str(out / "elastic_twin"))
    job.start([0, 1, 2, 3])
    twin.start([0, 1, 2, 3])

    def snap(name):
        if job.member:
            _save(rank, out / f"elastic_{name}.npz",
                  gather_tree(job.state, job.state_shardings()))

    records = []
    for i, devices in enumerate(([0, 1], [0, 1, 2, 3], None)):
        job.train_step(batches[i])
        twin.train_step(batches[i])
        if devices is None:
            break
        snap(f"before{i}")
        records.append(job.migrate(devices))
        snap(f"after{i}")
    snap("final")
    _save(rank, out / "elastic_twin.npz",
          gather_tree(twin.state, twin.state_shardings()),
          {"records": records, "members": [job.member, twin.member]})


def _trainer(rank, out):
    """The carbon-aware trainer example on 4 ranks: its slices of 1, 2, 4
    and 8 chips are ranks [0], [0, 1] and [0..3] (twice), so a migration
    reshards the job across a real device subset."""
    from repro_torch.examples import carbon_train
    summary = carbon_train.main(["--device", "cpu", "--steps",
                                 str(TRAINER_STEPS)])
    if rank == 0:
        (out / "trainer.json").write_text(json.dumps(summary))


def job_four(rank, out):
    model = get_model(model_cfg())
    for shape in ("2x2", "4x1"):
        mesh = _mesh(shape)
        _grads(rank, out, mesh, shape, model)
        state = _steps(rank, out, mesh, shape, model)
        if shape == "2x2":
            kept = (state, mesh)
    _int8(rank, out, _mesh("2x2"), model)
    _shard_batch(rank, out)
    _reshard(rank, out, model, *kept)
    _elastic(rank, out, model)
    _trainer(rank, out)
    _collectives(rank, out, model)


def job_two(rank, out):
    """(1, 2): the heads divide the model axis (4:2), and do not (3:1,
    attention replicated over the model axis, its weights gathered).
    A mesh larger than the process group is refused."""
    try:
        make_mesh(MeshConfig(data=4), "cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    local = describe(make_local_mesh(model=2, device_type="cpu"))
    if rank == 0:
        (out / "refused.json").write_text(json.dumps({"error": refused,
                                                      "local": local}))
    mesh = _mesh("1x2")
    _grads(rank, out, mesh, "1x2", get_model(model_cfg()))
    _steps(rank, out, mesh, "1x2", get_model(model_cfg()))
    _steps(rank, out, mesh, "1x2_heads3", get_model(model_cfg((3, 1))),
           "state0_heads3")


def job_fault(rank, out):
    """Rank 1 raises while rank 0 waits in a collective."""
    if rank == 1:
        raise RuntimeError("deliberate fault on rank 1")
    dist.all_reduce(torch.ones(1))


JOBS = {"four": job_four, "two": job_two, "fault": job_fault}
