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
                                       shard_tree, tree_map, unflatten)
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import loop as TL

SEQ, BATCH, MICRO = 16, 8, 4
N_MOE_STEPS = 3
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


def _topk(rank, out, mesh, model):
    """top-k steps one at a time from the reference's state of each step."""
    opt = OptimizerConfig(**opt_kw("topk"))
    step = TL.make_train_step(model, TrainConfig(**train_kw(),
                                                 optimizer=opt), mesh)
    sh = TL.state_shardings(model, opt, mesh)
    for i, batch in enumerate(_batches(out)):
        state = shard_tree(_state(model, opt, _load(out / f"topk_state{i}.npz")),
                           sh)
        state, m = step(state, batch)
        _save(rank, out / f"topk_{i}.npz", gather_tree(state, sh),
              _floats(m))


# leaves of `topk_tree`: shape and PartitionSpec on (data 2, model 2): split
# over no axis, one, two (on one dimension and on two), and one whose k-th
# largest |g| is tied across shards
TOPK_LEAVES = {"whole": ((6, 10), (None, None)),
               "rows": ((8, 6), ("data", None)),
               "both_dims": ((4, 6, 4), ("model", None, "data")),
               "one_dim": ((8, 5), (("data", "model"), None)),
               "ties": ((8, 8), ("model", None))}
TOPK_RATIO = 0.25


def topk_tree(seed=3):
    """(grads, error feedback) of `TOPK_LEAVES`, made with numpy: normal
    entries, and in "ties" 10 entries of |g| 5 and 10 of |g| 3 (signs
    mixed, spread over the rows) among values below 1, so that its
    threshold (k = 16 of 64) is 3 and all ten 3s are kept."""
    rng = np.random.default_rng(seed)
    g = {k: rng.normal(size=sh).astype(np.float32)
         for k, (sh, _) in TOPK_LEAVES.items()}
    e = {k: (0.1 * rng.normal(size=sh)).astype(np.float32)
         for k, (sh, _) in TOPK_LEAVES.items()}
    ties = (rng.uniform(-0.9, 0.9, size=64)).astype(np.float32)
    where = rng.permutation(64)
    ties[where[:10]] = 5.0 * rng.choice([-1, 1], 10)
    ties[where[10:20]] = 3.0 * rng.choice([-1, 1], 10)
    g["ties"], e["ties"] = ties.reshape(8, 8), np.zeros((8, 8), np.float32)
    return g, e


def _topk_unit(rank, out):
    """`compress_topk(..., shardings=)` on (2, 2) on the local shards of
    `topk_tree`; kept entries and error feedback gathered."""
    from repro_torch.train.compression import compress_topk
    mesh = _mesh("2x2")
    sh = {k: SH.NamedSharding(mesh, spec)
          for k, (_, spec) in TOPK_LEAVES.items()}
    g, e = topk_tree()
    local = lambda tree: {k: sh[k].shard(torch.from_numpy(v))  # noqa: E731
                          for k, v in tree.items()}
    COLL.COUNTER.reset()
    with COLL.COUNTER.on():
        kept, ef = compress_topk(local(g), local(e), TOPK_RATIO,
                                 shardings=sh)
    records = list(COLL.COUNTER.records)
    whole = {f"{name}/{k}": sh[k].gather(v).numpy()
             for name, tree in (("kept", kept), ("ef", ef))
             for k, v in tree.items()}
    if rank == 0:
        np.savez(out / "topk_unit.npz", **whole)
        (out / "topk_unit.json").write_text(json.dumps(records))


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
    _topk(rank, out, _mesh("2x2"), model)
    _topk_unit(rank, out)
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


# ---------------------------------------------------------------------------
# The MoE family and serving on a mesh (`tests/test_torch_mesh_serve.py`;
# the reference's side is `tests/torch_mesh_reference.py`)
# ---------------------------------------------------------------------------

SERVE_ARCHS = ("smollm-135m", "olmoe-1b-7b")
MOE_ARCH = "olmoe-1b-7b"
LAYER_B, LAYER_S, LAYER_B_ODD = 4, 16, 3      # B_ODD: no data axis divides
CFS = (1.25, 8.0)
LOSS_B, LOSS_S = 4, 16
STEP_B, STEP_MICRO = 8, 4
SERVE_B, PROMPT, DECODE = 4, 12, 8
PADS = (24, 21)       # 24: the model axes (2, 4) divide it; 21: neither
ENGINE_NEW = 8
FOUR = {"layer": ("2x2", "1x4", "4x1"), "odd": ("2x2",),
        "loss": ("2x2", "1x4", "4x1"), "serve": ("2x2", "1x4"),
        "engine": ("2x2",)}
TWO = {"layer": ("1x2", "2x1"), "serve": ("1x2",)}


def shape_of(name):
    return tuple(int(x) for x in name.split("x"))


def serve_cfg(arch, **kw):
    """The smoke config of `arch` in float32."""
    return dataclasses.replace(get_arch(arch).smoke, dtype="float32", **kw)


def moe_hidden(cfg, B, S, seed):
    """Hidden states with a shared direction, so that the router favours
    some experts and capacity binds (as `tests/test_torch_moe.py`)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model)) + 1.5 * rng.normal(
        size=cfg.d_model)
    return x.astype(np.float32)


def prompts(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def lm_batch(cfg, B, S, seed):
    tok = prompts(cfg, B, S + 1, seed)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def kept(dispatch_combine, k, T, D):
    """The kept mask (T, k), read through a dispatch-and-combine function
    itself: tokens of ones, the identity as the expert FFN and routing
    weight 1 on choice j only give y[:, 0] = keep[:, j] (as
    `tests/test_torch_moe.py`)."""
    choice = np.eye(k, dtype=np.float32)
    cols = [np.asarray(dispatch_combine(np.ones((T, D), np.float32),
                                        choice[[j] * T]))[:, 0]
            for j in range(k)]
    return np.stack(cols, axis=1) == 1.0


def _ref_params(out, arch):
    """The reference's PRNGKey(0) parameters of `arch` (or of a family
    key, `family_cfg`), written by the reference's side, through
    `convert.from_reference_params`."""
    from repro_torch.convert import from_reference_params
    flat = dict(np.load(out / f"params_{arch}.npz"))
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    cfg = family_cfg(arch) if arch in FAMILY_KEYS else serve_cfg(arch)
    return from_reference_params(cfg, tree, device="cpu")


def _gather_rows(x, mesh, ndim):
    """A tensor whose rows are split over the batch axes, whole."""
    spec = (mesh.batch or None,) + (None,) * (ndim - 1)
    return SH.gather_tensor(x, spec, mesh)


def _moe_layer(rank, out, shape, cf, B, tag):
    """`moe_apply` on the mesh: y gathered, lb_loss, router_dropped, and
    this process's kept mask read through the dispatch it ran."""
    from repro_torch.models import moe as MOE
    cfg = serve_cfg(MOE_ARCH, capacity_factor=cf)
    mesh = _mesh(shape).for_batch((B, LAYER_S))
    p = {k: v[0] for k, v in _ref_params(out, MOE_ARCH)["layers"]["moe"]
         .items()}
    p = shard_tree(p, param_shardings(MOE.moe_specs(cfg), mesh))
    x = torch.from_numpy(moe_hidden(cfg, B, LAYER_S, 11))
    x = SH.NamedSharding(mesh, SH.logical_to_pspec(
        ("batch", "seq", None), x.shape, mesh)).shard(x)
    calls = []
    real = MOE._dispatch_combine_local

    def spy(cfg_, x_flat, ids, weights, capacity, ffn, e0=0, n_local=0):
        calls.append((ids, capacity, e0, n_local))
        return real(cfg_, x_flat, ids, weights, capacity, ffn, e0, n_local)
    MOE._dispatch_combine_local = spy
    try:
        y, aux = MOE.moe_apply(cfg, p, x, mesh=mesh)
    finally:
        MOE._dispatch_combine_local = real
    (ids, capacity, e0, n_local), = calls
    keep = kept(lambda xs, w: real(cfg, torch.from_numpy(xs), ids,
                                   torch.from_numpy(w), capacity,
                                   lambda b: b, e0, n_local)[0],
                cfg.top_k, ids.shape[0], cfg.d_model)
    y = _gather_rows(y, mesh, 3)
    np.savez(out / f"layer_{tag}_r{rank}.npz", y=y.numpy(), keep=keep,
             lb=float(aux["lb_loss"]), drop=float(aux["router_dropped"]),
             capacity=capacity, e0=e0, n_local=n_local,
             coords=np.array([mesh.index("data"), mesh.index("model")]),
             expert_parallel=MOE.expert_parallel(cfg, mesh, B))


def _moe_grads(rank, out, shape):
    """OLMoE's loss and gradients on the mesh at the reference's params."""
    model = get_model(serve_cfg(MOE_ARCH))
    mesh = _mesh(shape)
    sh = model.shardings(mesh)
    leaves = TL._grad_leaves(shard_tree(_ref_params(out, MOE_ARCH), sh))
    run_mesh = mesh.for_batch((LOSS_B, LOSS_S))
    batch = shard_batch(lm_batch(model.cfg, LOSS_B, LOSS_S, 3), run_mesh)
    loss, metrics = TL._backward(model, "none", leaves, batch, run_mesh)
    _save(rank, out / f"moe_grads_{shape}.npz",
          gather_tree(TL._grads(leaves), sh),
          {"loss": float(loss), **_floats(metrics)})


def moe_train_cfg():
    return TrainConfig(seq_len=LOSS_S, global_batch=STEP_B,
                       microbatch=STEP_MICRO,
                       optimizer=OptimizerConfig(**opt_kw()))


def moe_state0(params):
    """A train state at `params` with zero moments."""
    return {"params": params,
            "opt": {"m": tree_map(torch.zeros_like, params),
                    "v": tree_map(torch.zeros_like, params)},
            "step": torch.zeros((), dtype=torch.int32)}


def moe_step_batch(cfg, i):
    return lm_batch(cfg, STEP_B, LOSS_S, 20 + i)


def _moe_steps(rank, out, shape):
    """Three AdamW steps of OLMoE on the mesh from the reference's
    params; then the state checkpointed and restored onto the other
    meshes (the expert axis resharded)."""
    model = get_model(serve_cfg(MOE_ARCH))
    tcfg = moe_train_cfg()
    mesh = _mesh(shape)
    sh = TL.state_shardings(model, tcfg.optimizer, mesh)
    state = shard_tree(moe_state0(_ref_params(out, MOE_ARCH)), sh)
    step = TL.make_train_step(model, tcfg, mesh)
    metrics = []
    for i in range(N_MOE_STEPS):
        state, m = step(state, moe_step_batch(model.cfg, i))
        metrics.append(_floats(m))
    _save(rank, out / f"moe_steps_{shape}.npz", gather_tree(state, sh),
          metrics)
    return state, sh


def _moe_reshard(rank, out, state, sh):
    """The (2, 2) state checkpointed, restored onto (1, 4) and (4, 1)."""
    model = get_model(serve_cfg(MOE_ARCH))
    opt = moe_train_cfg().optimizer
    mgr = CKPT.CheckpointManager(str(out / "moe_ckpt"), keep=1,
                                 async_save=False)
    mgr.save(N_MOE_STEPS, state, shardings=sh)
    dist.barrier()
    for target in ("1x4", "4x1"):
        tsh = TL.state_shardings(model, opt, _mesh(target))
        restored, _ = mgr.restore(TL.abstract_state(model, opt),
                                  shardings=tsh)
        _save(rank, out / f"moe_restore_{target}.npz",
              gather_tree(restored, tsh))
    dist.barrier()


def _serve(rank, out, arch, shape, pad):
    """Prefill, then DECODE greedy steps on the mesh: each step's logits
    gathered, the final cache gathered and this process's shard of it."""
    from repro_torch.launch.collectives import COUNTER
    model = get_model(serve_cfg(arch))
    cfg = model.cfg
    mesh = _mesh(shape).for_batch((SERVE_B, PROMPT))
    params = model.prepare(shard_tree(_ref_params(out, arch),
                                      model.shardings(mesh)))
    toks = torch.from_numpy(prompts(cfg, SERVE_B, PROMPT, 7)).long()
    lsh = SH.NamedSharding(mesh, SH.logical_to_pspec(
        ("batch", "tp"), (SERVE_B, cfg.vocab_size), mesh))
    tsh = SH.NamedSharding(mesh, SH.logical_to_pspec(
        ("batch",), (SERVE_B,), mesh))
    COUNTER.reset()
    with COUNTER.on():
        logits, cache = model.prefill(params, shard_batch({"tokens": toks},
                                                          mesh),
                                      pad_to=pad, mesh=mesh)
    prefill_records = list(COUNTER.records)
    steps = [lsh.gather(logits)]
    for _ in range(DECODE):
        tok = torch.argmax(steps[-1], -1)
        logits, cache = model.decode(params, cache, tsh.shard(tok),
                                     mesh=mesh)
        steps.append(lsh.gather(logits))
    csh = model.cache_shardings(SERVE_B, pad, mesh)
    tag = f"{arch}_{shape}_{pad}"
    np.savez(out / f"serve_{tag}_r{rank}.npz",
             k_local=cache["k"].numpy(), v_local=cache["v"].numpy(),
             coords=np.array([mesh.index("data"), mesh.index("model")]))
    full = {n: csh[n].gather(cache[n]).numpy() for n in ("k", "v")}
    if rank == 0:
        np.savez(out / f"serve_{tag}.npz",
                 logits=np.stack([s.numpy() for s in steps]), **full)
        (out / f"serve_{tag}.json").write_text(json.dumps(
            {"pos": cache["pos"], "prefill_collectives": prefill_records}))


def _engine(rank, out, arch, shape):
    """`ServeEngine(mesh=)`'s greedy tokens."""
    from repro_torch.serve.engine import ServeEngine
    model = get_model(serve_cfg(arch))
    mesh = _mesh(shape)
    eng = ServeEngine(model, mesh=mesh)
    eng.params = shard_tree(_ref_params(out, arch), model.shardings(mesh))
    res = eng.generate(prompts(model.cfg, SERVE_B, PROMPT, 9), ENGINE_NEW)
    if rank == 0:
        np.savez(out / f"engine_{arch}_{shape}.npz", tokens=res["tokens"])
        (out / f"engine_{arch}_{shape}.json").write_text(json.dumps(
            res["stats"]))


def _mesh_serve_job(rank, out, plan):
    for shape in plan["layer"]:
        for cf in CFS:
            _moe_layer(rank, out, shape, cf, LAYER_B, f"{shape}_{cf}")
    for shape in plan.get("odd", ()):
        _moe_layer(rank, out, shape, CFS[0], LAYER_B_ODD, f"{shape}_odd")
    for shape in plan.get("loss", ()):
        _moe_grads(rank, out, shape)
        kept_state = _moe_steps(rank, out, shape)
        if shape == "2x2":
            _moe_reshard(rank, out, *kept_state)
    for arch in (SERVE_ARCHS if "engine" in plan else (MOE_ARCH,)):
        for shape in plan["serve"]:
            for pad in PADS:
                _serve(rank, out, arch, shape, pad)
        for shape in plan.get("engine", ()):
            _engine(rank, out, arch, shape)


def job_moe_four(rank, out):
    _mesh_serve_job(rank, out, FOUR)


def job_moe_two(rank, out):
    _mesh_serve_job(rank, out, TWO)


# ---------------------------------------------------------------------------
# The ssm, hybrid and encdec families on a mesh
# (`tests/test_torch_mesh_families.py`; the reference's side is
# `tests/torch_mesh_reference.py OUT families ARCH`)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("mamba2-2.7b", "recurrentgemma-9b", "whisper-base")
LAYER_NORM = "whisper-base-ln"   # Whisper's smoke config with layer norms
FAMILY_KEYS = FAMILY_ARCHS + (LAYER_NORM,)
FAM_MESHES = ("2x2", "1x4", "4x1")
FAM_REMAT = {"2x2": "full", "1x4": "dots"}      # besides "none" everywhere
FAM_PROMPT = 32        # twice RecurrentGemma's window of 16: the ring wraps;
                       # two of Mamba-2's SSD chunks of 16
FAM_STEP_B, FAM_STEP_MICRO = 8, 4
FAM_CKPT_TARGETS = ("1x4", "4x1")


def family_cfg(key):
    """The smoke config of a family key in float32; `LAYER_NORM` is
    Whisper's with layer norms (a scale and a bias each), the published
    config's norm, which the smoke config leaves out."""
    if key == LAYER_NORM:
        return serve_cfg("whisper-base", norm_kind="layer")
    return serve_cfg(key)


def family_pads(key):
    """The serving tests' pad_to: for an encoder-decoder two capacities
    past the prompt and its decode steps, one that the model axes (2, 4)
    divide and one they do not; the O(1)-state families ignore pad_to,
    so the prompt's length and a longer one."""
    if family_cfg(key).family == "encdec":
        return (48, 43)
    return (FAM_PROMPT, 48)


def family_meshes(key):
    """The meshes of a key's loss and serving tests: Whisper's layer-norm
    variant on (1, 4) only (heads, d_ff, vocabulary and the residual's
    sequence split four ways)."""
    return ("1x4",) if key == LAYER_NORM else FAM_MESHES


def frames(cfg, B, seed):
    """Encoder frames (B, enc_seq, d_model), made with numpy from `seed`."""
    return np.random.default_rng(seed).normal(
        size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def family_batch(cfg, B, S, seed):
    """`lm_batch`, and an encoder-decoder's frames."""
    out = lm_batch(cfg, B, S, seed)
    if cfg.family == "encdec":
        out["frames"] = frames(cfg, B, seed + 100)
    return out


def family_prompts(cfg):
    """The serving tests' prompts (and an encoder-decoder's frames)."""
    out = {"tokens": prompts(cfg, SERVE_B, FAM_PROMPT, 7)}
    if cfg.family == "encdec":
        out["frames"] = frames(cfg, SERVE_B, 8)
    return out


def family_train_cfg(compression="none"):
    return TrainConfig(seq_len=LOSS_S, global_batch=FAM_STEP_B,
                       microbatch=FAM_STEP_MICRO, steps=1, log_every=0,
                       optimizer=OptimizerConfig(**opt_kw(compression)))


def family_state0(params, compression="none"):
    """A train state at `params` with zero moments (and error feedback)."""
    state = moe_state0(params)
    if compression != "none":
        state["ef"] = tree_map(torch.zeros_like, params)
    return state


def _fam_grads(rank, out, key, shape, remat):
    """The loss and gradients of `key` on the mesh at the reference's
    params, under `remat`."""
    model = get_model(family_cfg(key))
    mesh = _mesh(shape)
    sh = model.shardings(mesh)
    leaves = TL._grad_leaves(shard_tree(_ref_params(out, key), sh))
    run_mesh = mesh.for_batch((LOSS_B, LOSS_S))
    batch = shard_batch(family_batch(model.cfg, LOSS_B, LOSS_S, 3), run_mesh)
    loss, metrics = TL._backward(model, remat, leaves, batch, run_mesh)
    _save(rank, out / f"fam_grads_{key}_{shape}_{remat}.npz",
          gather_tree(TL._grads(leaves), sh),
          {"loss": float(loss), **_floats(metrics)})


def _fam_serve(rank, out, key, shape, pad):
    """Prefill, then DECODE greedy steps on the mesh: each step's logits
    gathered; every cache leaf gathered, and this process's shard of
    it."""
    model = get_model(family_cfg(key))
    cfg = model.cfg
    mesh = _mesh(shape).for_batch((SERVE_B, FAM_PROMPT))
    params = model.prepare(shard_tree(_ref_params(out, key),
                                      model.shardings(mesh)))
    lsh = SH.NamedSharding(mesh, SH.logical_to_pspec(
        ("batch", "tp"), (SERVE_B, cfg.vocab_size), mesh))
    tsh = SH.NamedSharding(mesh, SH.logical_to_pspec(
        ("batch",), (SERVE_B,), mesh))
    logits, cache = model.prefill(params, shard_batch(family_prompts(cfg),
                                                      mesh),
                                  pad_to=pad, mesh=mesh)
    steps = [lsh.gather(logits)]
    for _ in range(DECODE):
        logits, cache = model.decode(params, cache,
                                     tsh.shard(torch.argmax(steps[-1], -1)),
                                     mesh=mesh)
        steps.append(lsh.gather(logits))
    csh = dict(flatten(model.cache_shardings(SERVE_B, pad, mesh)))
    local = {p: t for p, t in flatten(cache) if isinstance(t, torch.Tensor)}
    tag = f"{key}_{shape}_{pad}"
    np.savez(out / f"fam_serve_{tag}_r{rank}.npz",
             **{p: t.numpy() for p, t in local.items()},
             coords=np.array([mesh.index("data"), mesh.index("model")]))
    full = {p: csh[p].gather(t).numpy() for p, t in local.items()}
    if rank == 0:
        np.savez(out / f"fam_serve_{tag}.npz",
                 logits=np.stack([s.numpy() for s in steps]), **full)
        (out / f"fam_serve_{tag}.json").write_text(json.dumps(
            {"pos": cache["pos"]}))


def _fam_engine(rank, out, key, shape="2x2"):
    """`ServeEngine(mesh=)`'s greedy tokens (an encoder-decoder fed the
    engine's zero frames)."""
    from repro_torch.serve.engine import ServeEngine
    model = get_model(family_cfg(key))
    mesh = _mesh(shape)
    eng = ServeEngine(model, mesh=mesh)
    eng.params = shard_tree(_ref_params(out, key), model.shardings(mesh))
    res = eng.generate(prompts(model.cfg, SERVE_B, FAM_PROMPT, 9),
                       ENGINE_NEW)
    if rank == 0:
        np.savez(out / f"fam_engine_{key}.npz", tokens=res["tokens"])
        (out / f"fam_engine_{key}.json").write_text(json.dumps(
            res["stats"]))


def _fam_steps(rank, out, key, shape="2x2"):
    """One AdamW step of `key` on the mesh through `train.loop.run` (two
    microbatches of 4 rows, grad_clip active) from the reference's
    params; then one int8 step from the same params; then the AdamW
    state checkpointed and restored onto FAM_CKPT_TARGETS."""
    model = get_model(family_cfg(key))
    mesh = _mesh(shape)
    params = _ref_params(out, key)
    batch = family_batch(model.cfg, FAM_STEP_B, LOSS_S, 20)
    states = {}
    for compression in ("none", "int8"):
        tcfg = family_train_cfg(compression)
        sh = TL.state_shardings(model, tcfg.optimizer, mesh)
        state = shard_tree(family_state0(params, compression), sh)
        res = TL.run(model, tcfg, iter([batch]), mesh=mesh, state=state)
        _save(rank, out / f"fam_steps_{key}_{compression}.npz",
              gather_tree(res["state"], sh), res["history"])
        states[compression] = (res["state"], sh)
    state, sh = states["none"]
    mgr = CKPT.CheckpointManager(str(out / f"fam_ckpt_{key}"), keep=1,
                                 async_save=False)
    mgr.save(1, state, shardings=sh)
    dist.barrier()
    opt = family_train_cfg().optimizer
    for target in FAM_CKPT_TARGETS:
        tsh = TL.state_shardings(model, opt, _mesh(target))
        restored, _ = mgr.restore(TL.abstract_state(model, opt),
                                  shardings=tsh)
        _save(rank, out / f"fam_restore_{key}_{target}.npz",
              gather_tree(restored, tsh))
    dist.barrier()


def _fam_elastic(rank, out, key):
    """An ElasticJob of `key` on ranks 0-3 takes a step and migrates to
    ranks 0-1: its state gathered before and after."""
    model = get_model(family_cfg(key))
    job = ElasticJob(model, family_train_cfg(), str(out / f"fam_el_{key}"))
    job.start([0, 1, 2, 3])
    job.train_step(family_batch(model.cfg, FAM_STEP_B, LOSS_S, 21))
    before = gather_tree(job.state, job.state_shardings())
    record = job.migrate([0, 1])
    if job.member:
        after = gather_tree(job.state, job.state_shardings())
        _save(rank, out / f"fam_elastic_{key}_after.npz", after,
              {"n_devices": record["n_devices"], "step": record["step"]})
    _save(rank, out / f"fam_elastic_{key}_before.npz", before)


def job_fam_four(rank, out):
    for key in FAMILY_KEYS:
        for shape in family_meshes(key):
            _fam_grads(rank, out, key, shape, "none")
        if key in FAMILY_ARCHS:
            for shape, remat in FAM_REMAT.items():
                _fam_grads(rank, out, key, shape, remat)
        for shape in family_meshes(key):
            for pad in family_pads(key):
                _fam_serve(rank, out, key, shape, pad)
    for key in FAMILY_ARCHS:
        _fam_engine(rank, out, key)
        _fam_steps(rank, out, key)
    _fam_elastic(rank, out, "mamba2-2.7b")


def _kernel_spy():
    """Record the shape each kernel entry of the model path (`kernels.
    ops`: ssd, rglru, mha) is called with, and whether it is under grad
    (its first input requires it)."""
    from repro_torch.kernels import ops
    calls = []

    def wrap(name):
        real = getattr(ops, name)

        def call(x, *args, **kw):
            calls.append((name, list(x.shape), x.requires_grad))
            return real(x, *args, **kw)
        setattr(ops, name, call)
    for name in ("ssd", "rglru", "mha"):
        wrap(name)
    return calls


def job_fam_two(rank, out):
    """(1, 2): each family's loss and gradients, then a prefill, with the
    kernel entries' calls recorded: the heads or channels each process's
    SSD, RG-LRU and attention calls see."""
    calls = _kernel_spy()
    record = {}
    for key in FAMILY_ARCHS:
        calls.clear()
        _fam_grads(rank, out, key, "1x2", "none")
        model = get_model(family_cfg(key))
        mesh = _mesh("1x2").for_batch((SERVE_B, FAM_PROMPT))
        params = model.prepare(shard_tree(_ref_params(out, key),
                                          model.shardings(mesh)))
        n_train = len(calls)
        model.prefill(params, shard_batch(family_prompts(model.cfg), mesh),
                      pad_to=FAM_PROMPT + 1, mesh=mesh)
        record[key] = {"train": calls[:n_train], "prefill": calls[n_train:]}
    (out / f"fam_kernels_r{rank}.json").write_text(json.dumps(record))


JOBS = {"four": job_four, "two": job_two, "fault": job_fault,
        "moe_four": job_moe_four, "moe_two": job_moe_two,
        "fam_four": job_fam_four, "fam_two": job_fam_two}


# ---------------------------------------------------------------------------
# The dry run's per-device argument bytes on abstract meshes
# (`tests/test_torch_dryrun_mesh.py`; the reference's side is
# `tests/torch_mesh_reference.py OUT argbytes MESH`, eight JAX CPU devices)
# ---------------------------------------------------------------------------

ARGBYTES_MESHES = {"2x4": ((2, 4), ("data", "model")),
                   "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ARGBYTES_ARCHS = ("smollm-135m", "olmoe-1b-7b", "mamba2-2.7b",
                  "recurrentgemma-9b", "whisper-base")
ARGBYTES_SHAPES = ("train_4k", "decode_32k")
ARGBYTES_CASES = ([(a, s, "default") for a in ARGBYTES_ARCHS
                   for s in ARGBYTES_SHAPES]
                  + [(a, s, r) for a in ARGBYTES_ARCHS[:2]
                     for r in ("PURE_DP", "SERVE_TP")
                     for s in ARGBYTES_SHAPES])


def reference_rule_sets() -> dict:
    """{"default": None, "PURE_DP": ..., "SERVE_TP": ...} as the
    reference's hill-climber defines them, read from its source
    (importing it would set XLA_FLAGS for the whole process)."""
    import ast
    src = (Path(__file__).resolve().parents[1] / "src" / "repro" / "launch"
           / "hillclimb.py")
    out = {"default": None}
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in ("PURE_DP", "SERVE_TP"):
                out[name] = ast.literal_eval(node.value)
    return out
