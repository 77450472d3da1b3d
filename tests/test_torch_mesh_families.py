"""The ssm (Mamba-2), hybrid (RecurrentGemma) and encdec (Whisper)
families on a mesh, on the CPU: gloo process groups of 4 and 2 ranks
(`tests/torch_mesh_ranks.py`, spawned as in `tests/test_torch_mesh.py`)
against the reference's own mesh paths and the port's unsharded ones.

The reference's side runs in processes of its own, one a family, side
by side (`tests/torch_mesh_reference.py OUT families ARCH`, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4
JAX_PLATFORMS=cpu``: this process's JAX has one CPU device): each
writes its smoke config's PRNGKey(0) parameters first, which the ranks
load (through `convert.from_reference_params`), then its results under
meshes of 4 devices. Each process and each gloo job runs under its own
time limit, and the pytest process never joins a process group.

Bars (float32): the loss within 1e-5 relative and every gradient within
1e-5 of its leaf's max |g|, save Mamba-2's a_log and dt_bias, held at
their float32-bound bars of 1.1e-4 and 1.3e-5 (`tests/test_torch_train_
ssm.py`); prefill and 8 decode steps: logits within 1e-5 of their max,
greedy tokens equal, every cache leaf gathered within 1e-5 of its max
and each rank's shard exactly the slice its `Model.cache_pspecs` names;
the engines' tokens equal; a train step on the mesh allclose at 1e-5 to
the port's unsharded step (int8: one step, the entries within rounding
of a quantization tie exempt, as in `tests/test_torch_mesh.py`);
checkpoints and migrations bit for bit.
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
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.models.sharding import _local_view  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402
from test_torch_mesh import _load, _rel, _spawn  # noqa: E402
from test_torch_mesh_serve import _CoordMesh, _await_file  # noqa: E402
from test_torch_train import TIE_WINDOW, _int8_tie_sites  # noqa: E402

HELPER = Path(__file__).resolve().parent / "torch_mesh_reference.py"
REFERENCE_TIMEOUT_S = 420
JOB_TIMEOUT_S = 300
# Mamba-2's decay pair: the reference's own float32 gradients sit this
# far from its float64 loss's (`tests/test_torch_train_ssm.py`)
DECAY_BARS = {"a_log": 1.1e-4, "dt_bias": 1.3e-5}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One directory with the reference's results and the ranks'."""
    out = tmp_path_factory.mktemp("mesh_families")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    procs = {}
    for arch in R.FAMILY_ARCHS:
        log = open(out / f"reference_{arch}.log", "w")
        procs[arch] = subprocess.Popen(
            [sys.executable, str(HELPER), str(out), "families", arch],
            env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
        log.close()
    deadline = time.monotonic() + REFERENCE_TIMEOUT_S
    try:
        for arch, proc in procs.items():
            _await_file(out / f"params_{arch}.done", proc, deadline)
        _spawn("fam_four", 4, out, timeout=JOB_TIMEOUT_S)
        _spawn("fam_two", 2, out, timeout=JOB_TIMEOUT_S)
        for proc in procs.values():
            proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    for arch, proc in procs.items():
        assert proc.returncode == 0, (out / f"reference_{arch}.log"
                                      ).read_text()
        assert (out / f"reference_{arch}.done").exists()
    return out


def _grad_bar(key: str, path: str) -> float:
    leaf = path.rsplit("/", 1)[-1]
    if R.family_cfg(key).family == "ssm" and leaf in DECAY_BARS:
        return DECAY_BARS[leaf]
    return 1e-5


# ---------------------------------------------------------------------------
# Training on a mesh
# ---------------------------------------------------------------------------

LOSS_CASES = ([(k, s, "none") for k in R.FAMILY_KEYS
               for s in R.family_meshes(k)]
              + [(k, s, r) for k in R.FAMILY_ARCHS
                 for s, r in R.FAM_REMAT.items()])


@pytest.mark.parametrize("key,shape,remat", LOSS_CASES)
def test_family_loss_and_grads_match_the_references(key, shape, remat, runs):
    """The loss within 1e-5 relative and every gathered gradient leaf
    within its bar of the leaf's max, against the reference's
    value_and_grad jitted under its mesh of the same shape (its remat
    policy changes no value: the port's "full" and "dots" are held to
    its plain run)."""
    meta = json.loads((runs / f"fam_grads_{key}_{shape}_{remat}.json")
                      .read_text())
    got = _load(runs / f"fam_grads_{key}_{shape}_{remat}.npz")
    want = _load(runs / f"ref_fam_grads_{key}_{shape}.npz")
    loss = float(want.pop("loss"))
    assert abs(meta["loss"] - loss) <= 1e-5 * loss
    assert abs(meta["ce_loss"] - loss) <= 1e-5 * loss
    assert set(got) == set(want)
    bad = {p: _rel(got[p], w) for p, w in want.items()
           if _rel(got[p], w) > _grad_bar(key, p)}
    assert not bad, bad


@pytest.mark.parametrize("key", R.FAMILY_ARCHS)
def test_family_grads_on_two_processes_equal_the_unsharded_port(key, runs):
    """On (1, 2), a job of two processes, the loss and every gradient
    leaf within 1e-5 (of the leaf's max) of the port's unsharded
    value_and_grad, and the loss within 1e-5 of the reference's."""
    model = get_model(R.family_cfg(key))
    batch = {k: torch.as_tensor(v) for k, v in R.family_batch(
        model.cfg, R.LOSS_B, R.LOSS_S, 3).items()}
    (loss, _), grads = TL._value_and_grad(model, "none", R._ref_params(runs, key),
                                          batch)
    meta = json.loads((runs / f"fam_grads_{key}_1x2_none.json").read_text())
    assert abs(meta["loss"] - float(loss)) <= 1e-5 * float(loss)
    ref = float(_load(runs / f"ref_fam_grads_{key}_2x2.npz")["loss"])
    assert abs(meta["loss"] - ref) <= 1e-5 * ref
    got = _load(runs / f"fam_grads_{key}_1x2_none.npz")
    bad = {p: _rel(got[p], g.numpy()) for p, g in flatten(grads)
           if _rel(got[p], g.numpy()) > 1e-5}
    assert not bad, bad


def _unsharded_step(runs: Path, key: str, compression: str):
    """The port's unsharded `make_train_step` from the reference's params
    on the step's batch, in the same microbatches."""
    model = get_model(R.family_cfg(key))
    step = TL.make_train_step(model, R.family_train_cfg(compression))
    batch = to_device(R.family_batch(model.cfg, R.FAM_STEP_B, R.LOSS_S, 20),
                      "cpu")
    state, m = step(R.family_state0(R._ref_params(runs, key), compression), batch)
    return ({p: t.detach().numpy() for p, t in flatten(state)},
            {k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("key", R.FAMILY_ARCHS)
def test_family_step_on_a_mesh_equals_the_unsharded_step(key, runs):
    """One AdamW step through `train.loop.run` on (2, 2) (two
    microbatches, grad_clip active: the whole-tree norm over every leaf,
    the SSM's head-split a_log, dt_bias and d_skip included) equals the
    port's unsharded step: params, m and v allclose at 1e-5, loss and
    grad_norm within 1e-5 relative."""
    want, wm = _unsharded_step(runs, key, "none")
    history = json.loads((runs / f"fam_steps_{key}_none.json").read_text())
    assert wm["grad_norm"] > R.opt_kw()["grad_clip"]
    for k in ("loss", "grad_norm"):
        assert abs(history[0][k] - wm[k]) <= 1e-5 * abs(wm[k]), k
    got = _load(runs / f"fam_steps_{key}_none.npz")
    assert set(got) == set(want)
    for path, b in want.items():
        close = np.abs(got[path] - b) <= 1e-5 + 1e-5 * np.abs(b)
        assert close.all(), (path, int((~close).sum()))


@pytest.mark.parametrize("key", R.FAMILY_ARCHS)
def test_family_int8_step_on_a_mesh_equals_the_unsharded_step(key, runs,
                                                               monkeypatch):
    """int8 compression, one step on (2, 2) from the reference's params:
    params, m, v and the error feedback allclose at 1e-5 to the port's
    unsharded step, save the entries within TIE_WINDOW of a quantization
    tie in that step (at most 2 x 2 x TIE_WINDOW of them), whose int8
    level may round either way; the loss within 1e-5 relative."""
    ties = _int8_tie_sites(monkeypatch)
    want, wm = _unsharded_step(runs, key, "int8")
    n = sum(t.numel() for t in ties.values())
    assert sum(int(t.sum()) for t in ties.values()) <= 2 * 2 * TIE_WINDOW * n
    history = json.loads((runs / f"fam_steps_{key}_int8.json").read_text())
    assert abs(history[0]["loss"] - wm["loss"]) <= 1e-5 * abs(wm["loss"])
    got = _load(runs / f"fam_steps_{key}_int8.npz")
    assert set(got) == set(want)
    for path, b in want.items():
        close = np.abs(got[path] - b) <= 1e-5 + 1e-5 * np.abs(b)
        leaf = path.split("/", 2)[-1] if path.startswith("opt/") else (
            path.split("/", 1)[-1])
        if leaf in ties and path != "step":
            close |= ties[leaf].numpy()
        assert close.all(), (path, int((~close).sum()))


@pytest.mark.parametrize("key,target", [(k, t) for k in R.FAMILY_ARCHS
                                        for t in R.FAM_CKPT_TARGETS])
def test_family_checkpoint_reshards_bit_for_bit(key, target, runs):
    """The state after the step on (2, 2), checkpointed and restored onto
    (1, 4) and (4, 1) (the SSM's heads, the RG-LRU's channels and the
    attention's heads resharded): every leaf bit-equal."""
    saved = _load(runs / f"fam_steps_{key}_none.npz")
    got = _load(runs / f"fam_restore_{key}_{target}.npz")
    assert set(got) == set(saved)
    for p, a in saved.items():
        assert got[p].dtype == a.dtype and np.array_equal(got[p], a), p


def test_elastic_migration_of_a_mamba2_job_is_bit_equal(runs):
    """An ElasticJob of Mamba-2 on 4 ranks takes a step and migrates to 2:
    the gathered state after the migration is the one before, bit for
    bit."""
    before = _load(runs / "fam_elastic_mamba2-2.7b_before.npz")
    after = _load(runs / "fam_elastic_mamba2-2.7b_after.npz")
    meta = json.loads((runs / "fam_elastic_mamba2-2.7b_after.json")
                      .read_text())
    assert meta == {"n_devices": 2, "step": 1}
    assert set(before) == set(after)
    for p, a in before.items():
        assert np.array_equal(after[p], a), p


# ---------------------------------------------------------------------------
# Serving on a mesh
# ---------------------------------------------------------------------------

SERVE_CASES = [(k, s, p) for k in R.FAMILY_KEYS for s in R.family_meshes(k)
               for p in R.family_pads(k)]


@pytest.mark.parametrize("key,shape,pad", SERVE_CASES)
def test_family_prefill_and_decode_match_the_references(key, shape, pad,
                                                        runs):
    """Prefill of 4 x 32 tokens (RecurrentGemma's ring of 16 slots wraps;
    Whisper's frames seeded), then 8 greedy decode steps on the mesh,
    against the reference's jitted prefill and decode under its mesh:
    every step's gathered logits within 1e-5 of their max and its greedy
    tokens equal; every gathered cache leaf within 1e-5 of its max; each
    rank's shard of each leaf exactly the slice of the gathered leaf its
    `Model.cache_pspecs` names. The O(1)-state families ignore pad_to
    (as the reference does): both capacities are held to its run at the
    prompt's length."""
    tag = f"{key}_{shape}_{pad}"
    ref_pad = pad if R.family_cfg(key).family == "encdec" else \
        R.family_pads(key)[0]
    got = _load(runs / f"fam_serve_{tag}.npz")
    want = _load(runs / f"ref_fam_serve_{key}_{shape}_{ref_pad}.npz")
    meta = json.loads((runs / f"fam_serve_{tag}.json").read_text())
    assert meta["pos"] == int(want.pop("pos")) == R.FAM_PROMPT + R.DECODE
    logits, wlogits = got.pop("logits"), want.pop("logits")
    assert logits.shape == wlogits.shape
    for a, b in zip(logits, wlogits):
        assert _rel(a, b) <= 1e-5
        assert np.array_equal(a.argmax(-1), b.argmax(-1))
    assert set(got) == set(want)
    for n, w in want.items():
        assert got[n].shape == w.shape and _rel(got[n], w) <= 1e-5, n
    model = get_model(R.family_cfg(key))
    mesh = dict(zip(("data", "model"), R.shape_of(shape)))
    specs = dict(flatten(model.cache_pspecs(R.SERVE_B, pad, mesh)))
    for rank in range(int(np.prod(R.shape_of(shape)))):
        z = _load(runs / f"fam_serve_{tag}_r{rank}.npz")
        view = _CoordMesh(mesh, dict(zip(("data", "model"),
                                         (int(c) for c in z.pop("coords")))))
        assert set(z) == set(got)
        for n, t in z.items():
            local = _local_view(torch.from_numpy(got[n]), specs[n], view)
            assert np.array_equal(t, local.numpy()), (rank, n)


def test_family_caches_split_as_the_rules_say(runs):
    """On (1, 4) the caches are split where the rules split them:
    Mamba-2's conv history over its channels and its SSD state over its
    heads, RecurrentGemma's states over the recurrence's channels and its
    ring over the window's slots, Whisper's self- and cross-attention
    caches over their slots (48 slots and 32 encoder positions divide 4)
    and its self-attention cache not at 43 slots."""
    def local(key, pad, leaf):
        return _load(runs / f"fam_serve_{key}_1x4_{pad}_r1.npz")[leaf].shape

    cfg = R.family_cfg("mamba2-2.7b")
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    assert local("mamba2-2.7b", 48, "conv")[3] == conv_dim // 4
    assert local("mamba2-2.7b", 48, "ssm")[2] == cfg.ssm_n_heads // 4
    cfg = R.family_cfg("recurrentgemma-9b")
    assert local("recurrentgemma-9b", 48, "super/rec1/h")[2] == (
        cfg.lru_width // 4)
    assert local("recurrentgemma-9b", 48, "super/k")[3] == (
        cfg.local_window // 4)
    cfg = R.family_cfg("whisper-base")
    assert local("whisper-base", 48, "k")[3] == 48 // 4
    assert local("whisper-base", 48, "ck")[3] == cfg.enc_seq // 4
    assert local("whisper-base", 43, "k")[3] == 43


@pytest.mark.parametrize("key", R.FAMILY_ARCHS)
def test_family_engine_on_a_mesh_equals_the_references(key, runs):
    """`ServeEngine(mesh=)` on (2, 2): 8 greedy tokens of 4 prompts equal
    the reference engine's under its mesh (Whisper's engine feeds zero
    frames, laid out by rows as `shard_batch` lays them out); its stats
    count the whole batch."""
    got = _load(runs / f"fam_engine_{key}.npz")["tokens"]
    want = _load(runs / f"ref_fam_engine_{key}.npz")["tokens"]
    np.testing.assert_array_equal(got, want)
    stats = json.loads((runs / f"fam_engine_{key}.json").read_text())
    assert stats["prefill_tokens"] == R.SERVE_B * R.FAM_PROMPT
    assert stats["decode_tokens"] == R.SERVE_B * R.ENGINE_NEW


# ---------------------------------------------------------------------------
# The kernels see local shards
# ---------------------------------------------------------------------------

def _calls(runs: Path, key: str, where: str) -> list:
    out = []
    for rank in range(2):
        rec = json.loads((runs / f"fam_kernels_r{rank}.json").read_text())
        out.append([tuple((n, tuple(s), g)) for n, s, g in rec[key][where]])
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("key", R.FAMILY_ARCHS)
def test_kernels_run_on_local_shards(key, runs):
    """On (1, 2) each process's kernel entries see its shard: Mamba-2's
    SSD scan 2 of its 4 heads, once a layer in training (its input
    requiring grad) and in the prefill; RecurrentGemma's RG-LRU scan 32
    of its 64 channels, once a recurrent block, and its multi-query
    attention every head;
    Whisper's attention 2 of its 4 heads, once a layer of the encoder and
    twice of the decoder. The local rows are the whole batch (no data
    axis)."""
    cfg = R.family_cfg(key)
    for where, B, seq, grad in (("train", R.LOSS_B, R.LOSS_S, True),
                                ("prefill", R.SERVE_B, R.FAM_PROMPT, False)):
        calls = _calls(runs, key, where)
        if cfg.family == "ssm":
            want = [("ssd", (B, seq, cfg.ssm_n_heads // 2, cfg.ssm_head_dim),
                     grad)] * cfg.n_layers
        elif cfg.family == "hybrid":
            rec = ("rglru", (B, seq, cfg.lru_width // 2), grad)
            attn = ("mha", (B, seq, cfg.n_heads, cfg.head_dim), grad)
            want = [rec, rec, attn] * (cfg.n_layers // 3)
        else:
            enc = ("mha", (B, cfg.enc_seq, cfg.n_heads // 2, cfg.head_dim),
                   grad)
            dec = ("mha", (B, seq, cfg.n_heads // 2, cfg.head_dim), grad)
            want = [enc] * cfg.n_enc_layers + [dec, dec] * cfg.n_layers
        assert calls == want, (where, calls)
