"""The dense family's training sharded over a mesh, on the CPU: gloo
process groups of 4 and 2 ranks, each rank a process started with
``torch.multiprocessing`` ("spawn"), against the JAX reference's
single-device step and the port's unsharded one.

Three jobs, each under its own time limit (`JOB_TIMEOUT_S`); the
pytest process never joins a process group, and a rank that raises or
hangs fails its own job's tests only (`test_a_rank_that_raises_fails_
its_job_within_the_limit`). The ranks run `tests/torch_mesh_ranks.py`,
which imports neither JAX nor the reference; the inputs (the
reference's states, the batches) go to them as ``.npz`` files and what
they computed comes back the same way, gathered to full tensors.

Bars (float32): loss within 1e-5 relative, gradients within 1e-5 of
each leaf's max |g|; after three AdamW steps (grad_clip 0.5, active:
the first step's norm is above it) params and moments allclose at 1e-5,
as `tests/test_torch_train.py` compares them; int8 one step at a time
from the reference's state, entries within rounding of a quantization
tie exempt, as there. Checkpoints and migrations: bit for bit.
"""
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.config import OptimizerConfig as RefOptCfg  # noqa: E402
from repro.config import TrainConfig as RefTrainCfg  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.train import loop as REF_TL  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro_torch.config import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.convert import from_reference_state  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.collectives import _wire_bytes  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models.params import flatten, tree_map  # noqa: E402
from repro_torch.train import compression as COMP  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402
from test_torch_train import (TIE_WINDOW, _compare_state,  # noqa: E402
                              _int8_tie_sites)

JOB_TIMEOUT_S = 120
N_STEPS = 3


def _spawn(job: str, world: int, out: Path, timeout: float = JOB_TIMEOUT_S):
    """Run `job` on `world` spawned ranks; raise if one fails or the job
    outlives `timeout` (every rank is killed either way)."""
    ctx = mp.start_processes(R.run, args=(world, job, str(out / "store"),
                                          str(out)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh job {job!r} outlived {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def _np_tree(tree):
    return {p: np.asarray(t) for p, t in flatten(jax.tree.map(np.asarray,
                                                              tree))}


def _torch_flat(tree):
    return {p: t.detach().numpy() for p, t in flatten(tree)}


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# The reference's side, computed once
# ---------------------------------------------------------------------------

def _ref_model():
    cfg = dataclasses.replace(ref_get_arch("smollm-135m").smoke,
                              dtype="float32", head_dim=16)
    return ref_get_model(cfg)


@pytest.fixture(scope="module")
def reference():
    """The reference's init state, three steps, first-batch gradients
    and the int8 states of each step; the batches."""
    model = _ref_model()
    data = SyntheticLM(256, R.SEQ, R.BATCH, seed=5)
    batches = [b for _, b in zip(range(N_STEPS), data)]
    opt = RefOptCfg(**R.opt_kw())
    state0 = REF_TL.init_state(model, opt, jax.random.PRNGKey(0))
    step = jax.jit(REF_TL.make_train_step(
        model, RefTrainCfg(**R.train_kw(), optimizer=opt)))
    state, metrics = state0, []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        metrics.append({k: float(v) for k, v in m.items()})
    (loss, _), grads = jax.value_and_grad(
        lambda p, b: model.loss(p, b), has_aux=True)(
        state0["params"], jax.tree.map(jnp.asarray, batches[0]))
    opt8 = RefOptCfg(**R.opt_kw("int8"))
    step8 = jax.jit(REF_TL.make_train_step(
        model, RefTrainCfg(**R.train_kw(), optimizer=opt8)))
    s8 = [REF_TL.init_state(model, opt8, jax.random.PRNGKey(0))]
    losses8 = []
    for b in batches:
        s, m = step8(s8[-1], jax.tree.map(jnp.asarray, b))
        s8.append(s)
        losses8.append(float(m["loss"]))
    optk = RefOptCfg(**R.opt_kw("topk"))
    stepk = jax.jit(REF_TL.make_train_step(
        model, RefTrainCfg(**R.train_kw(), optimizer=optk)))
    sk = [REF_TL.init_state(model, optk, jax.random.PRNGKey(0))]
    lossesk = []
    for b in batches:
        s, m = stepk(sk[-1], jax.tree.map(jnp.asarray, b))
        sk.append(s)
        lossesk.append(float(m["loss"]))
    return {"batches": batches, "state0": _np_tree(state0),
            "steps": _np_tree(state), "metrics": metrics,
            "loss": float(loss), "grads": _np_tree(grads),
            "int8": [jax.tree.map(np.asarray, s) for s in s8],
            "int8_losses": losses8,
            "topk": [jax.tree.map(np.asarray, s) for s in sk],
            "topk_losses": lossesk}


def _write_inputs(out: Path, ref):
    np.savez(out / "batches.npz", **{
        f"{k}{i}": b[k] for i, b in enumerate(ref["batches"])
        for k in ("tokens", "labels")})
    np.savez(out / "state0.npz", **ref["state0"])
    for i, s in enumerate(ref["int8"][:-1]):
        np.savez(out / f"int8_state{i}.npz", **_np_tree(s))
    for i, s in enumerate(ref["topk"][:-1]):
        np.savez(out / f"topk_state{i}.npz", **_np_tree(s))
    model = get_model(R.model_cfg((3, 1)))
    np.savez(out / "state0_heads3.npz", **_torch_flat(TL.init_state(
        model, OptimizerConfig(**R.opt_kw()), 0, "cpu")))


@pytest.fixture(scope="module")
def four(reference, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_four")
    _write_inputs(out, reference)
    _spawn("four", 4, out)
    return out


@pytest.fixture(scope="module")
def two(reference, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_two")
    _write_inputs(out, reference)
    _spawn("two", 2, out)
    return out


def _job(shape, four, two):
    return two if shape.startswith("1x2") else four


def _port_steps(cfg, state0, batches):
    """The port's unsharded three steps on the CPU."""
    model = get_model(cfg)
    opt = OptimizerConfig(**R.opt_kw())
    step = TL.make_train_step(model, TrainConfig(**R.train_kw(),
                                                 optimizer=opt))
    state = R._state(model, opt, {k: torch.from_numpy(v.copy())
                                  for k, v in state0.items()})
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return _torch_flat(state), metrics


def _assert_state(got: dict, want: dict, what: str):
    """params and opt allclose at 1e-5 (absolute and relative); the step
    counter equal."""
    assert set(got) == set(want), what
    for path, b in want.items():
        a = got[path]
        if path == "step":
            assert int(a) == int(b), what
            continue
        close = np.abs(a - b) <= 1e-5 + 1e-5 * np.abs(b.astype(np.float32))
        assert close.all(), (what, path, int((~close).sum()))


# ---------------------------------------------------------------------------
# Numerics against the reference and the unsharded port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["2x2", "4x1", "1x2"])
def test_sharded_loss_and_grads_equal_the_reference(shape, reference, four,
                                                    two):
    """The loss within 1e-5 relative and every gathered gradient leaf
    within 1e-5 of the leaf's max |g|, against the reference's
    single-device value_and_grad (and the port's unsharded one)."""
    out = _job(shape, four, two)
    got = _load(out / f"grads_{shape}.npz")
    meta = json.loads((out / f"grads_{shape}.json").read_text())
    assert abs(meta["loss"] - reference["loss"]) <= 1e-5 * reference["loss"]
    assert set(got) == set(reference["grads"])
    bad = {p: _rel(got[p], w) for p, w in reference["grads"].items()
           if _rel(got[p], w) > 1e-5}
    assert not bad, bad
    model = get_model(R.model_cfg())
    params = R._state(model, OptimizerConfig(), {
        k: torch.from_numpy(v.copy()) for k, v in reference["state0"].items()
    })["params"]
    (_, _), grads = TL._value_and_grad(model, "none", params, {
        k: torch.as_tensor(v) for k, v in reference["batches"][0].items()})
    for p, g in _torch_flat(grads).items():
        assert _rel(got[p], g) <= 1e-5, p


@pytest.mark.parametrize("shape", ["2x2", "4x1", "1x2"])
def test_sharded_steps_equal_the_reference(shape, reference, four, two):
    """Three AdamW steps (2 microbatches of 4, grad_clip active): params,
    m and v allclose at 1e-5 of the reference's, each step's loss and
    grad_norm within 1e-5 relative."""
    out = _job(shape, four, two)
    got = _load(out / f"steps_{shape}.npz")
    metrics = json.loads((out / f"steps_{shape}.json").read_text())
    assert metrics[0]["grad_norm"] > R.opt_kw()["grad_clip"]
    for m, w in zip(metrics, reference["metrics"]):
        for k in ("loss", "grad_norm"):
            assert abs(m[k] - w[k]) <= 1e-5 * abs(w[k]), (k, m[k], w[k])
    _assert_state(got, reference["steps"], shape)


@pytest.mark.parametrize("shape", ["2x2", "4x1", "1x2", "1x2_heads3"])
def test_sharded_steps_equal_the_ports_unsharded_steps(shape, reference,
                                                       four, two):
    """The same three steps against the port's unsharded `make_train_step`
    on the CPU, at the same bars; "1x2_heads3" has 3 query heads and 1
    key head, which the model axis of 2 does not divide, so attention
    runs whole on both processes with its weights gathered."""
    out = _job(shape, four, two)
    heads = (3, 1) if shape.endswith("heads3") else (4, 2)
    state0 = (_load(out / "state0_heads3.npz") if heads == (3, 1)
              else reference["state0"])
    want, wmet = _port_steps(R.model_cfg(heads), state0,
                             reference["batches"])
    metrics = json.loads((out / f"steps_{shape}.json").read_text())
    for m, w in zip(metrics, wmet):
        for k in ("loss", "grad_norm"):
            assert abs(m[k] - w[k]) <= 1e-5 * abs(w[k]), (k, m[k], w[k])
    _assert_state(_load(out / f"steps_{shape}.npz"), want, shape)


@pytest.mark.parametrize("i", range(N_STEPS))
def test_int8_steps_on_the_mesh_equal_the_reference(i, reference, four,
                                                    monkeypatch):
    """int8 compression on (2, 2), one step at a time from the
    reference's state of step `i`: params, m, v and the error feedback
    within 1e-5 (allclose), save for the entries within TIE_WINDOW of a
    quantization tie in the port's own unsharded step from that state
    (at most 2 x 2 x TIE_WINDOW of the entries), whose int8 level may
    round either way; the loss within 1e-5 relative."""
    ties = _int8_tie_sites(monkeypatch)
    cfg = R.model_cfg()
    model = get_model(cfg)
    opt = OptimizerConfig(**R.opt_kw("int8"))
    step = TL.make_train_step(model, TrainConfig(**R.train_kw(),
                                                 optimizer=opt))
    step(from_reference_state(cfg, reference["int8"][i], "cpu"),
         {k: torch.as_tensor(v) for k, v in reference["batches"][i].items()})
    n = sum(t.numel() for t in ties.values())
    assert sum(int(t.sum()) for t in ties.values()) <= 2 * 2 * TIE_WINDOW * n
    state = tree_map(torch.from_numpy, _unflat(_load(four / f"int8_{i}.npz")))
    _compare_state(state, reference["int8"][i + 1], ("params", "opt", "ef"),
                   ties, f"int8 step {i}")
    loss = json.loads((four / f"int8_{i}.json").read_text())["loss"]
    want = reference["int8_losses"][i]
    assert abs(loss - want) <= 1e-5 * abs(want)


# an entry whose |gf| lies within TOPK_WINDOW x the leaf's max |gf| of the
# top-k threshold may be kept on one side and not the other: the sharded
# and the reference's gradients differ in their last float32 bits
TOPK_WINDOW = 1e-5


def _topk_tie_sites(monkeypatch):
    """Record, per parameter path, the entries whose top-k input |gf| lies
    within TOPK_WINDOW x max |gf| of the leaf's threshold, by observing
    the port's unsharded `compress_topk` calls."""
    ties = {}
    real = COMP.compress_topk

    def observed(grads, ef, ratio=0.05, shardings=None):
        e = dict(flatten(ef))
        for path, g in flatten(grads):
            mag = (g.float() + e[path]).abs()
            k = max(1, int(mag.numel() * ratio))
            thresh = torch.topk(mag.reshape(-1), k).values[-1]
            near = (mag - thresh).abs() <= TOPK_WINDOW * mag.max()
            ties[path] = ties.get(path, torch.zeros_like(near)) | near
        return real(grads, ef, ratio, shardings)
    monkeypatch.setattr(COMP, "compress_topk", observed)
    return ties


@pytest.mark.parametrize("i", range(N_STEPS))
def test_topk_steps_on_the_mesh_equal_the_reference(i, reference, four,
                                                    monkeypatch):
    """top-k compression on (2, 2), one step at a time from the
    reference's state of step `i` (the reference's top-k step, whose
    threshold is each whole leaf's k-th largest |g|): params, m, v and
    the error feedback within 1e-5 (allclose), save for the entries
    within TOPK_WINDOW of the threshold in the port's own unsharded step
    from that state (counted: at most 1e-3 of the entries), which may be
    kept on one side only; the loss within 1e-5 relative."""
    ties = _topk_tie_sites(monkeypatch)
    cfg = R.model_cfg()
    model = get_model(cfg)
    opt = OptimizerConfig(**R.opt_kw("topk"))
    step = TL.make_train_step(model, TrainConfig(**R.train_kw(),
                                                 optimizer=opt))
    step(from_reference_state(cfg, reference["topk"][i], "cpu"),
         {k: torch.as_tensor(v) for k, v in reference["batches"][i].items()})
    n = sum(t.numel() for t in ties.values())
    assert sum(int(t.sum()) for t in ties.values()) <= 1e-3 * n
    state = tree_map(torch.from_numpy, _unflat(_load(four / f"topk_{i}.npz")))
    _compare_state(state, reference["topk"][i + 1], ("params", "opt", "ef"),
                   ties, f"topk step {i}")
    loss = json.loads((four / f"topk_{i}.json").read_text())["loss"]
    want = reference["topk_losses"][i]
    assert abs(loss - want) <= 1e-5 * abs(want)


def test_sharded_topk_equals_the_unsharded_one_bit_for_bit(four):
    """`compress_topk(..., shardings=)` on (2, 2) on local shards of a
    seeded tree (leaves split over no axis, one, two, and one whose k-th
    largest |g| is tied across shards) gives the unsharded function on
    the whole tensors bit for bit: kept entries and error feedback; every
    tie at the threshold is kept. The threshold's gathers are recorded:
    one all-gather per axis that splits a leaf."""
    g, e = R.topk_tree()
    kept, ef = COMP.compress_topk(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in e.items()}, R.TOPK_RATIO)
    got = _load(four / "topk_unit.npz")
    for k in R.TOPK_LEAVES:
        for name, want in (("kept", kept[k]), ("ef", ef[k])):
            a = got[f"{name}/{k}"]
            assert a.dtype == np.float32 and np.array_equal(
                a, want.numpy()), (name, k)
    assert int((got["kept/ties"] != 0).sum()) == 20
    records = json.loads((four / "topk_unit.json").read_text())
    n_axes = sum(len(SH.spec_axes(x)) for _, spec in R.TOPK_LEAVES.values()
                 for x in spec)
    assert [r[0] for r in records] == ["all-gather"] * n_axes


@pytest.mark.parametrize("shape", ["2x2", "4x1"])
@pytest.mark.parametrize("rank", [0, 1])
def test_abstract_mesh_records_equal_the_real_meshes(shape, rank, reference,
                                                     four):
    """The `_collectives` step (one counted train step from the seed) on
    an abstract mesh (`Mesh.abstract`: no process group, this process
    alone) at rank `rank`'s coordinates records the same collectives as
    the real gloo mesh's rank, item for item: kind, result bytes, group
    size, axis and stride."""
    from repro_torch.launch import collectives as COLL
    from repro_torch.launch.mesh import make_abstract_mesh
    data, model_n = (int(x) for x in shape.split("x"))
    mesh = make_abstract_mesh((data, model_n), ("data", "model"), "cpu",
                              {"data": rank // model_n,
                               "model": rank % model_n})
    model = get_model(R.model_cfg())
    opt = OptimizerConfig(**R.opt_kw())
    step = TL.make_train_step(model, TrainConfig(**R.train_kw(),
                                                 optimizer=opt), mesh)
    state = TL.init_state(model, opt, 0, mesh=mesh)
    COLL.COUNTER.reset()
    with COLL.COUNTER.on():
        step(state, reference["batches"][0])
    got = [list(r) for r in COLL.COUNTER.records]
    COLL.COUNTER.reset()
    want = json.loads((four / f"collectives_r{rank}.json").read_text())[
        shape]["records"]
    assert len(got) == len(want) > 0
    assert got == want


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


# ---------------------------------------------------------------------------
# Batches, checkpoints, migration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["2x2", "4x1"])
def test_shard_batch_gives_each_rank_its_rows(shape, reference, four):
    """Rank (data d, model m) holds rows [d·B/D, (d+1)·B/D) of the global
    batch, whatever m, and every sequence position."""
    data = 2 if shape == "2x2" else 4
    rows = R.BATCH // data
    for rank in range(4):
        z = _load(four / f"batch_{shape}_r{rank}.npz")
        d = int(z["coords"][0])
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(
                z[k], reference["batches"][0][k][d * rows:(d + 1) * rows])


@pytest.mark.parametrize("target", ["4x1", "1x2", "one", "plain"])
def test_checkpoint_from_2x2_restores_bit_for_bit(target, four):
    """A checkpoint written on (2, 2) restores onto (4, 1), (1, 2), one
    rank's (1, 1) mesh and one rank without a mesh: every leaf equal bit
    for bit to the state that was saved."""
    saved = _load(four / "steps_2x2.npz")
    got = _load(four / f"restore_{target}.npz")
    assert set(got) == set(saved)
    for p, a in saved.items():
        assert got[p].dtype == a.dtype and np.array_equal(got[p], a), p


def test_elastic_migration_keeps_the_state_bit_equal(four):
    """ElasticJob 4 -> 2 -> 4 ranks: the gathered state after each
    migration is the one before it, bit for bit; each record has
    save_s, restore_s, bytes, n_devices and step."""
    for i in range(2):
        before = _load(four / f"elastic_before{i}.npz")
        after = _load(four / f"elastic_after{i}.npz")
        assert set(before) == set(after)
        for p, a in before.items():
            assert np.array_equal(after[p], a), (i, p)
    meta = json.loads((four / "elastic_twin.json").read_text())
    nbytes = sum(a.nbytes for a in _load(four / "elastic_before0.npz")
                 .values())
    for rec, n, step in zip(meta["records"], (2, 4), (1, 2)):
        assert rec["n_devices"] == n and rec["step"] == step
        assert rec["bytes"] == nbytes
        assert rec["save_s"] >= 0 and rec["restore_s"] >= 0


def test_elastic_job_after_migrations_equals_an_unmigrated_one(four):
    """The third step after 4 -> 2 -> 4 equals an unmigrated job's third
    step within 1e-5 (allclose)."""
    got = _load(four / "elastic_final.npz")
    want = _load(four / "elastic_twin.npz")
    _assert_state(got, want, "migrated vs unmigrated")


def test_carbon_aware_trainer_migrates_across_real_device_subsets(four):
    """`examples.carbon_train` on 4 ranks (slices of 1, 2 and 4 ranks)
    logs the same intervals as on one process: the carbon intensity,
    slice, duty, action and C(t) of every interval equal, with the same
    two migrations, here from 4 ranks to 2 and from 2 to 1."""
    from repro_torch.core.carbon_aware_trainer import slice_device_lists
    from repro_torch.examples import carbon_train
    got = json.loads((four / "trainer.json").read_text())
    want = carbon_train.main(["--device", "cpu", "--steps",
                              str(R.TRAINER_STEPS)])
    assert got["migrations"] == want["migrations"] == 2
    moves = [x[2] for x in got["logs"] if x[5] == "migrate"]
    assert moves == ["dev-2", "dev-1"]
    assert [list(x) for x in want["logs"]] == got["logs"]
    fam, devs = carbon_train.demo_family("cpu")
    assert devs == [["cpu"]] * 4 == slice_device_lists(fam, "cpu")


# ---------------------------------------------------------------------------
# Collectives and the roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["2x2", "4x1", "1x2", "one"])
def test_collective_counter_records_what_the_step_issues(shape, four):
    """One step's counter records equal the collectives seen at the
    torch.distributed boundary (kind, result bytes, group size), each
    with its mesh axis and that axis's stride in row-major rank order,
    and its
    total wire bytes equal the ring formulas summed over them; on one
    rank nothing is issued and collective_s is 0.0, on more it is > 0."""
    for rank in (0, 1):
        rep = json.loads((four / f"collectives_r{rank}.json").read_text())
        if shape not in rep:
            assert shape == "one" and rank == 1
            continue
        r = rep[shape]
        assert [tuple(x[:3]) for x in r["records"]] == [tuple(x)
                                                        for x in r["seen"]]
        total = sum(_wire_bytes(k, b, n) for k, b, n in r["seen"])
        assert r["summary"]["total_wire_bytes"] == pytest.approx(total,
                                                                 rel=1e-12)
        if shape == "one":
            assert r["records"] == [] and r["collective_s"] == 0.0
        else:
            assert total > 0 and r["collective_s"] == total / 450e9
        sizes = ({} if shape == "one" else
                 dict(zip(("data", "model"), R.shape_of(shape))))
        for _, _, n, axis, stride in r["records"]:
            assert n == sizes[axis] and stride == (sizes["model"]
                                                   if axis == "data" else 1)


def test_collective_kinds_follow_the_mesh(four):
    """(4, 1) is data parallel with sharded weights: all-gathers of the
    weights, reduce-scatters of their gradients, all-reduces of the
    replicated leaves' gradients and the optimizer's statistics, nothing
    over the model axis. (2, 2) adds the model axis's sequence gathers
    and reduce-scatters."""
    rep = json.loads((four / "collectives_r0.json").read_text())
    kinds = {s: {r[0] for r in rep[s]["records"]} for s in ("4x1", "2x2")}
    assert kinds["4x1"] == {"all-gather", "reduce-scatter", "all-reduce"}
    assert {r[2] for r in rep["4x1"]["records"]} == {4}
    assert {r[2] for r in rep["2x2"]["records"]} == {2}
    assert (rep["2x2"]["summary"]["total_wire_bytes"]
            != rep["4x1"]["summary"]["total_wire_bytes"])


def test_make_mesh_refuses_a_mesh_larger_than_the_group(two):
    """(4, 1) on a group of 2 processes raises; it never shrinks. The
    local mesh with a model axis of 2 takes both processes."""
    rec = json.loads((two / "refused.json").read_text())
    assert rec["error"] is not None and "needs 4 processes" in rec["error"]
    assert rec["local"] == {"axes": {"data": 1, "model": 2}, "devices": 2}


# ---------------------------------------------------------------------------
# A rank that fails
# ---------------------------------------------------------------------------

def test_a_rank_that_raises_fails_its_job_within_the_limit(tmp_path):
    """Rank 1 raises while rank 0 waits in an all-reduce: the job fails,
    with rank 1's error or rank 0's lost connection to it (whichever the
    launcher sees first), well inside its limit."""
    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException,
                       match="deliberate fault|Connection|closed"):
        _spawn("fault", 2, tmp_path, timeout=60)
    assert time.monotonic() - t0 < 60
