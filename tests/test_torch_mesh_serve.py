"""The MoE family on a mesh and sharded serving, on the CPU: gloo process
groups of 4 and 2 ranks (`tests/torch_mesh_ranks.py`, spawned as in
`tests/test_torch_mesh.py`) against the reference's own mesh paths.

The reference's expert-parallel MoE (capacity per token shard × expert)
and its ``kv_seq`` decode cache run only under a JAX mesh of several
devices, and this process's JAX has one (`tests/conftest.py`); so the
reference's side runs in a process of its own,
`tests/torch_mesh_reference.py`, started with
``XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu``
(four CPU devices). It writes the smoke configs' PRNGKey(0) parameters
first, which the ranks load (through `convert.from_reference_params`)
while it goes on to compute its results; each of the three processes
runs under its own time limit, and the pytest process never joins a
process group.

Bars (float32): the MoE layer's output within 1e-5 of its max, its
``lb_loss`` and ``router_dropped`` within 1e-6 relative, every shard's
kept mask exactly; OLMoE's loss within 1e-5 relative and every gradient
within 1e-5 of the leaf's max; three AdamW steps allclose at 1e-5
against the port's unsharded steps with one microbatch per data shard;
a checkpoint resharded bit for bit; prefill and decode logits within
1e-5 of their max with greedy tokens equal, the gathered cache within
1e-5 of its max and each rank's shard exactly its PartitionSpec's
slice; the engine's tokens equal.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_mesh_ranks as R  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.models.sharding import _local_view  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402
from test_torch_mesh import _load, _rel, _spawn  # noqa: E402

HELPER = Path(__file__).resolve().parent / "torch_mesh_reference.py"
REFERENCE_TIMEOUT_S = 420
JOB_TIMEOUT_S = 240


def _await_file(path: Path, proc, deadline: float):
    while not path.exists():
        if proc.poll() is not None:
            raise RuntimeError(f"the reference's side exited with "
                               f"{proc.returncode}:\n{proc.stdout.read()}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"the reference's side wrote no {path.name}")
        time.sleep(0.2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One directory with the reference's results and the ranks'."""
    out = tmp_path_factory.mktemp("mesh_serve")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.Popen([sys.executable, str(HELPER), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    deadline = time.monotonic() + REFERENCE_TIMEOUT_S
    try:
        _await_file(out / "params.done", proc, deadline)
        _spawn("moe_four", 4, out, timeout=JOB_TIMEOUT_S)
        _spawn("moe_two", 2, out, timeout=JOB_TIMEOUT_S)
        log, _ = proc.communicate(timeout=max(deadline - time.monotonic(),
                                              1.0))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 0, log
    assert (out / "reference.done").exists()
    return out


def _ranks(shape: str) -> int:
    return int(np.prod(R.shape_of(shape)))


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

LAYER_TAGS = ([f"{s}_{cf}" for plan in (R.FOUR, R.TWO) for s in plan["layer"]
               for cf in R.CFS] + [f"{s}_odd" for s in R.FOUR["odd"]])


@pytest.mark.parametrize("tag", LAYER_TAGS)
def test_moe_layer_on_a_mesh_matches_the_references(tag, runs):
    """`moe_apply` on a mesh against the reference's under its JAX mesh
    (the expert-parallel ``shard_map``; for "odd", a batch the data axis
    does not divide, the local path over the whole batch on both sides):
    y within 1e-5 of its max, lb_loss and router_dropped within 1e-6
    relative, each shard's capacity and kept mask exactly."""
    shape = tag.split("_")[0]
    want = _load(runs / f"layer_{tag}.npz")
    for rank in range(_ranks(shape)):
        got = _load(runs / f"layer_{tag}_r{rank}.npz")
        assert _rel(got["y"], want["y"]) <= 1e-5, rank
        for k in ("lb", "drop"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-6 * abs(
                float(want[k])), (k, rank)
        assert bool(got["expert_parallel"]) == bool(want["expert_parallel"])
        assert int(got["capacity"]) == int(want["capacity"])
        i, j = got["coords"] if want["expert_parallel"] else (0, 0)
        assert np.array_equal(got["keep"], want["keep"][i, j]), rank
    assert bool(want["expert_parallel"]) == (not tag.endswith("odd"))
    if tag.endswith("8.0"):
        assert float(want["drop"]) == 0.0
    else:
        assert float(want["drop"]) > 0.0         # capacity binds


# ---------------------------------------------------------------------------
# OLMoE training on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", R.FOUR["loss"])
def test_moe_loss_and_grads_on_a_mesh_match_the_references(shape, runs):
    """OLMoE's loss within 1e-5 relative and lb_loss within 1e-6, and
    every gathered gradient leaf within 1e-5 of the leaf's max, against
    the reference's value_and_grad under its mesh."""
    got = _load(runs / f"moe_grads_{shape}.npz")
    meta = json.loads((runs / f"moe_grads_{shape}.json").read_text())
    want = _load(runs / f"ref_moe_grads_{shape}.npz")
    loss, lb = float(want.pop("loss")), float(want.pop("lb_loss"))
    assert abs(meta["loss"] - loss) <= 1e-5 * loss
    assert abs(meta["lb_loss"] - lb) <= 1e-6 * lb
    assert set(got) == set(want)
    bad = {p: _rel(got[p], w) for p, w in want.items()
           if _rel(got[p], w) > 1e-5}
    assert not bad, bad


def _unsharded_steps(runs: Path, data: int):
    """The port's unsharded three steps from the reference's params, in
    microbatches of one data shard's rows of each mesh microbatch."""
    model = get_model(R.serve_cfg(R.MOE_ARCH))
    mesh_cfg = R.moe_train_cfg()
    tcfg = TrainConfig(seq_len=mesh_cfg.seq_len,
                       global_batch=mesh_cfg.global_batch,
                       microbatch=mesh_cfg.microbatch // data,
                       optimizer=mesh_cfg.optimizer)
    step = TL.make_train_step(model, tcfg)
    state = R.moe_state0(R._ref_params(runs, R.MOE_ARCH))
    metrics = []
    for i in range(R.N_MOE_STEPS):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in
                                R.moe_step_batch(model.cfg, i).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {p: t.detach().numpy() for p, t in flatten(state)}, metrics


@pytest.mark.parametrize("shape", R.FOUR["loss"])
def test_moe_steps_on_a_mesh_equal_unsharded_microbatches(shape, runs):
    """Three AdamW steps of OLMoE on the mesh (2 microbatches of 4 rows,
    grad_clip active) equal the port's unsharded steps whose microbatches
    are one data shard's rows each (capacity is per data shard): params,
    m and v allclose at 1e-5, loss and grad_norm within 1e-5 relative
    (lb_loss is the last microbatch's, and the microbatches differ). At
    most 1e-3 of a leaf's parameters may miss the bar, each one whose
    first moment is within rounding of 0 (1e-5 of the leaf's max |m|),
    and then by less than the steps' size: Adam's normalisation makes a
    step of up to lr from that noise."""
    want, wmet = _unsharded_steps(runs, R.shape_of(shape)[0])
    metrics = json.loads((runs / f"moe_steps_{shape}.json").read_text())
    assert metrics[0]["grad_norm"] > R.opt_kw()["grad_clip"]
    for m, w in zip(metrics, wmet):
        for k in ("loss", "grad_norm"):
            assert abs(m[k] - w[k]) <= 1e-5 * abs(w[k]), (k, m[k], w[k])
    got = _load(runs / f"moe_steps_{shape}.npz")
    assert set(got) == set(want)
    assert int(got.pop("step")) == int(want.pop("step")) == R.N_MOE_STEPS
    for path, b in want.items():
        a = got[path]
        off = np.abs(a - b) > 1e-5 + 1e-5 * np.abs(b)
        if path.startswith("params/") and off.any():
            # a first moment within rounding of 0 (here ~1e-6 of the
            # leaf's max |m|), which Adam's normalisation turns into a
            # step of up to lr: its m and v are held at the bar, its
            # param only to the steps' size
            m = want["opt/m/" + path[len("params/"):]]
            noise = np.abs(m) <= 1e-5 * np.abs(m).max()
            far = np.abs(a - b) > 2 * R.N_MOE_STEPS * R.opt_kw()["lr"]
            assert off.mean() <= 1e-3 and not (off & (far | ~noise)).any(), (
                shape, path, int(off.sum()))
            continue
        assert not off.any(), (shape, path, int(off.sum()))


@pytest.mark.parametrize("target", ["1x4", "4x1"])
def test_moe_checkpoint_reshards_the_expert_axis(target, runs):
    """OLMoE's state after three steps on (2, 2), checkpointed and
    restored onto (1, 4) (4 experts' shards become 2 each) and (4, 1)
    (the experts whole, d_model split four ways): every leaf bit-equal."""
    saved = _load(runs / "moe_steps_2x2.npz")
    got = _load(runs / f"moe_restore_{target}.npz")
    assert set(got) == set(saved)
    for p, a in saved.items():
        assert got[p].dtype == a.dtype and np.array_equal(got[p], a), p


# ---------------------------------------------------------------------------
# Sharded prefill and decode
# ---------------------------------------------------------------------------

SERVE_CASES = ([(a, s, p) for a in R.SERVE_ARCHS for s in R.FOUR["serve"]
                for p in R.PADS]
               + [(R.MOE_ARCH, s, p) for s in R.TWO["serve"]
                  for p in R.PADS])


@pytest.mark.parametrize("arch,shape,pad", SERVE_CASES)
def test_sharded_prefill_and_decode_match_the_references(arch, shape, pad,
                                                         runs):
    """Prefill of 4 x 12 tokens, then 8 greedy decode steps on the mesh,
    against the reference's jitted prefill and decode under its mesh:
    every step's gathered logits within 1e-5 of their max and its greedy
    tokens equal; the gathered cache within 1e-5 of its max; each rank's
    cache shard exactly the slice of the gathered cache its
    PartitionSpec names (the sequence split over the model axis when
    `pad` divides, else whole)."""
    tag = f"{arch}_{shape}_{pad}"
    got = _load(runs / f"serve_{tag}.npz")
    want = _load(runs / f"ref_serve_{tag}.npz")
    meta = json.loads((runs / f"serve_{tag}.json").read_text())
    assert meta["pos"] == int(want["pos"]) == R.PROMPT + R.DECODE
    assert got["logits"].shape == want["logits"].shape
    for a, b in zip(got["logits"], want["logits"]):
        assert _rel(a, b) <= 1e-5
        assert np.array_equal(a.argmax(-1), b.argmax(-1))
    model = get_model(R.serve_cfg(arch))
    mesh = dict(zip(("data", "model"), R.shape_of(shape)))
    specs = model.cache_pspecs(R.SERVE_B, pad, mesh)
    split = specs["k"][3] is not None
    assert split == (pad % mesh["model"] == 0 and mesh["model"] > 1)
    for n in ("k", "v"):
        assert got[n].shape == want[n].shape
        assert _rel(got[n], want[n]) <= 1e-5
    for rank in range(_ranks(shape)):
        z = _load(runs / f"serve_{tag}_r{rank}.npz")
        coords = dict(zip(("data", "model"), (int(c) for c in z["coords"])))
        view = _CoordMesh(mesh, coords)
        for n in ("k", "v"):
            want_local = _local_view(torch.from_numpy(got[n]), specs[n],
                                     view).numpy()
            assert np.array_equal(z[f"{n}_local"], want_local), (rank, n)


class _CoordMesh:
    """Axis sizes and one process's coordinates, as `_local_view` reads
    a `sharding.Mesh`."""

    def __init__(self, sizes, coords):
        self.sizes, self.coords = sizes, coords

    def size(self, axis):
        return self.sizes.get(axis, 1)

    def index(self, axis):
        return self.coords.get(axis, 0)


@pytest.mark.parametrize("arch", R.SERVE_ARCHS)
def test_prefill_moves_keys_and_values_in_two_gathers_a_layer(arch, runs):
    """On (1, 4), where the heads divide the model axis (OLMoE's 4:4), the
    prefill gathers each layer's new keys and values over the heads (two
    all-gathers a layer, of the whole heads' bytes) before each process
    writes its chunk of the sequence; where they do not (SmolLM's 4:2
    heads, attention run whole on every process) there is none."""
    cfg = R.serve_cfg(arch)
    meta = json.loads((runs / f"serve_{arch}_1x4_24.json").read_text())
    kv_bytes = R.SERVE_B * R.PROMPT * cfg.n_kv_heads * cfg.head_dim * 4
    gathers = [r for r in meta["prefill_collectives"]
               if r[0] == "all-gather" and r[1] == kv_bytes]
    heads_split = cfg.n_kv_heads % 4 == 0 and cfg.n_heads % 4 == 0
    assert len(gathers) == (2 * cfg.n_layers if heads_split else 0)
    assert all(r[2] == 4 for r in gathers)


@pytest.mark.parametrize("arch", R.SERVE_ARCHS)
def test_serve_engine_on_a_mesh_equals_the_references(arch, runs):
    """`ServeEngine(mesh=)` on (2, 2): 8 greedy tokens of 4 prompts equal
    the reference engine's under its mesh; its stats count the whole
    batch."""
    got = _load(runs / f"engine_{arch}_2x2.npz")["tokens"]
    want = _load(runs / f"ref_engine_{arch}_2x2.npz")["tokens"]
    np.testing.assert_array_equal(got, want)
    stats = json.loads((runs / f"engine_{arch}_2x2.json").read_text())
    assert stats["prefill_tokens"] == R.SERVE_B * R.PROMPT
    assert stats["decode_tokens"] == R.SERVE_B * R.ENGINE_NEW
