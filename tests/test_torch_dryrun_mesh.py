"""The dry run on abstract meshes, the hill-climber and the roofline's
two links, on the CPU.

An abstract mesh (`sharding.Mesh.abstract`) is one device's share of a
mesh without a process group: its collectives return what a real group
would in shape and dtype and record themselves, and its parameters are
drawn at their shard shapes. Here: those collectives, the production
meshes, the per-device argument bytes against the reference's compiled
``argument_bytes`` (two processes of `tests/torch_mesh_reference.py
OUT argbytes MESH`, eight JAX CPU devices each, started when this
module's first test runs and read by its last), the probes'
extrapolated wire bytes against a whole step's, the dry run's
``--mesh`` CLI, `launch.hillclimb` against the reference's source, and
`roofline.axis_seconds`. The gloo meshes' records against an abstract
mesh's, and top-k compression on a mesh, are in
`tests/test_torch_mesh.py`, which owns those process groups.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

pytest.importorskip("jax")

import torch_mesh_ranks as R  # noqa: E402
from repro_torch.config import TRAIN, OptimizerConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import collectives as COLL  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.launch import dryrun_lib as DL  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.mesh import (make_abstract_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import (flatten, init_local,  # noqa: E402
                                       local_bytes, local_shape)
from repro_torch.train import loop as TL  # noqa: E402

HELPER = Path(__file__).resolve().parent / "torch_mesh_reference.py"
SRC = Path(__file__).resolve().parents[1] / "src"
REFERENCE_TIMEOUT_S = 300
SMALL_TRAIN = ShapeConfig("train_4k", 32, 16, TRAIN)   # 16 x 32 tokens


@pytest.fixture(scope="module", autouse=True)
def _argbytes_processes(tmp_path_factory):
    """The reference's compiles, one process a mesh, running while this
    module's other tests do."""
    out = tmp_path_factory.mktemp("argbytes")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    procs = {}
    for name in R.ARGBYTES_MESHES:
        log = open(out / f"argbytes_{name}.log", "w")
        procs[name] = subprocess.Popen(
            [sys.executable, str(HELPER), str(out), "argbytes", name],
            env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
        log.close()
    yield out, procs, time.monotonic() + REFERENCE_TIMEOUT_S
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


@pytest.fixture(scope="module")
def ref_argbytes(_argbytes_processes):
    out, procs, deadline = _argbytes_processes
    got = {}
    for name, proc in procs.items():
        proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
        assert proc.returncode == 0, (out / f"argbytes_{name}.log"
                                      ).read_text()[-3000:]
        got[name] = json.loads((out / f"argbytes_{name}.json").read_text())
    return got


# ---------------------------------------------------------------------------
# The abstract mesh
# ---------------------------------------------------------------------------

def test_abstract_collectives_return_a_real_groups_shapes_and_record():
    """On (data 2, model 4) at (1, 2): all_gather is the local shard
    repeated, reduce_scatter this coordinate's chunk, all_reduce a copy;
    each records (kind, result bytes, group size, axis, stride); an axis
    the mesh lacks (size 1) is skipped; there is no process group."""
    mesh = SH.Mesh.abstract({"data": 2, "model": 4}, {"data": 1, "model": 2},
                            "cpu")
    assert mesh.is_abstract and mesh.member and mesh.n_devices == 8
    assert (mesh.stride("data"), mesh.stride("model")) == (4, 1)
    x = torch.arange(12.0).reshape(3, 4)
    COLL.COUNTER.reset()
    with COLL.COUNTER.on():
        g = SH.all_gather(x, 1, mesh, "model")
        rs = SH.reduce_scatter(torch.arange(16.0).reshape(8, 2), 0, mesh,
                               "model")
        ar = SH.all_reduce(x, mesh, "data")
        assert SH.all_gather(x, 0, mesh, "pod") is x
    assert torch.equal(g, torch.cat([x] * 4, dim=1))
    assert torch.equal(rs, torch.arange(16.0).reshape(8, 2)[4:6])
    assert torch.equal(ar, x) and ar.data_ptr() != x.data_ptr()
    assert COLL.COUNTER.records == [("all-gather", 192, 4, "model", 1),
                                    ("reduce-scatter", 16, 4, "model", 1),
                                    ("all-reduce", 48, 2, "data", 4)]
    COLL.COUNTER.reset()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.group("data")
    with pytest.raises(ValueError, match="outside the axis"):
        SH.Mesh.abstract({"data": 2}, {"data": 2}, "cpu")


def test_production_meshes_are_abstract_and_need_no_group(monkeypatch):
    """The reference's 16x16 and 2x16x16 meshes, built with no process
    group; "cuda" without a card raises; `make_mesh` still needs a
    process group (it never builds an abstract mesh)."""
    from repro_torch.config import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    single = make_production_mesh(device="cpu")
    multi = make_production_mesh(multi_pod=True, device="cpu",
                                 coords={"pod": 1})
    assert single.sizes == {"data": 16, "model": 16} and single.is_abstract
    assert multi.sizes == {"pod": 2, "data": 16, "model": 16}
    assert multi.coords == {"pod": 1, "data": 0, "model": 0}
    assert multi.stride("pod") == 256
    assert make_abstract_mesh(MeshConfig(data=4, model=2), device="cpu"
                              ).sizes == {"data": 4, "model": 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(MeshConfig(), "cpu")
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(MeshConfig(data=2), "cpu")


def test_init_local_draws_each_shard_at_its_shape():
    """`init_local` on 16x16 at the published widths: every leaf at its
    shard shape, as many bytes as `local_bytes` counts; two devices that
    hold the same shard of a leaf draw the same values (the seed is the
    shard's index), two that hold different shards draw different
    ones."""
    model = get_model(get_arch("smollm-135m").full)
    specs = model.specs()
    at = lambda d, m: init_local(specs, make_production_mesh(  # noqa: E731
        device="cpu", coords={"data": d, "model": m}), 0)
    a, b, c = at(0, 0), at(0, 5), at(3, 0)
    pspecs = dict(flatten(model.pspecs({"data": 16, "model": 16})))
    total = 0
    for path, spec in flatten(specs):
        t = dict(flatten(a))[path]
        assert tuple(t.shape) == local_shape(spec.shape, pspecs[path],
                                             {"data": 16, "model": 16})
        total += t.numel() * t.element_size()
    assert total == local_bytes(specs, {"data": 16, "model": 16})
    coords = {"a": (0, 0), "b": (0, 5), "c": (3, 0)}
    drawn = {k: dict(flatten(t)) for k, t in (("a", a), ("b", b), ("c", c))}
    n_same = n_other = 0
    for path, spec in flatten(specs):
        axes = {x for e in pspecs[path] for x in SH.spec_axes(e)}
        if spec.init in ("zeros", "ones"):
            continue
        for k in ("b", "c"):
            same = all(coords[k][i] == coords["a"][i]
                       for i, ax in enumerate(("data", "model")) if ax in axes)
            equal = torch.equal(drawn[k][path], drawn["a"][path])
            assert equal == same, (path, k)
            n_same, n_other = n_same + same, n_other + (not same)
    assert n_other
    again = dict(flatten(at(0, 0)))
    assert all(torch.equal(again[p], t) for p, t in drawn["a"].items())


def test_rules_reach_the_threads_that_run_a_backward():
    """A rules override is seen by threads that entered no `rules_ctx`
    (autograd runs a CUDA backward, and a checkpointed block's
    recompute, on its own device threads), and is gone after it."""
    seen = []

    def probe():
        seen.append(SH.logical_to_pspec(("batch", "tp"), (8, 8),
                                        {"data": 2, "model": 2}))
    with SH.rules_ctx(hillclimb.PURE_DP):
        t = threading.Thread(target=probe)
        t.start()
        t.join()
        probe()
    t = threading.Thread(target=probe)
    t.start()
    t.join()
    assert seen == [(("data", "model"), None)] * 2 + [("data", "model")]


# ---------------------------------------------------------------------------
# The dry run on a mesh
# ---------------------------------------------------------------------------

def test_whisper_decode_reads_none_of_its_unread_parameters():
    """`Model.unread("decode")` names what Whisper's decode step does not
    read (its encoder, the cross-attention's key and value projections):
    a decode without them gives the same logits."""
    cfg = dataclasses.replace(get_arch("whisper-base").smoke, dtype="float32")
    model = get_model(cfg)
    params = model.prepare(model.init(0, "cpu"))
    tok = torch.randint(0, cfg.vocab_size, (2, 4),
                        generator=torch.Generator().manual_seed(1))
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model,
                         generator=torch.Generator().manual_seed(2))
    _, cache = model.prefill(params, {"tokens": tok, "frames": frames},
                             pad_to=8)
    unread = model.unread("decode")
    assert unread and model.unread("train") == ()
    kept = {p: t for p, t in flatten(params) if not p.startswith(unread)}
    assert len(kept) < len(flatten(params))
    tree: dict = {}
    for path, t in kept.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    clone = lambda c: {k: (v.clone() if isinstance(v, torch.Tensor)  # noqa: E731
                           else v) for k, v in c.items()}
    want, _ = model.decode(params, clone(cache), tok[:, -1])
    got, _ = model.decode(tree, clone(cache), tok[:, -1])
    assert torch.equal(got, want)


def test_probes_extrapolate_the_wire_bytes_of_the_whole_step():
    """SmolLM's smoke config at 4 layers on an abstract (2, 2) mesh: the
    marginal-layer probes (1 and 2 layers) extrapolate to the wire bytes
    by kind and by axis, the collective count and the kernels' calls of
    the 4-layer step counted whole (each is linear in the layers)."""
    cfg = dataclasses.replace(get_arch("smollm-135m").smoke, n_layers=4)
    mesh = make_abstract_mesh((2, 2), ("data", "model"), "cpu")
    res = DL.analyze_cell("smollm-135m", SMALL_TRAIN, "cpu", cfg=cfg,
                          mesh=mesh, probes=False)
    model = get_model(cfg)
    tcfg = TrainConfig(seq_len=32, global_batch=16, remat="full",
                       optimizer=OptimizerConfig())
    step = TL.make_train_step(model, tcfg, mesh)
    state = TL.init_state(model, tcfg.optimizer, 0, mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (16, 32), generator=gen)
             for k in ("tokens", "labels")}
    COLL.COUNTER.reset()
    with COLL.COUNTER.on():
        step(state, batch)
    want = COLL.COUNTER.summary()
    COLL.COUNTER.reset()
    got = res["collectives"]
    assert got["total_wire_bytes"] == pytest.approx(
        want["total_wire_bytes"], rel=1e-12)
    for group in ("per_kind", "per_axis"):
        assert got[group].keys() == want[group].keys()
        for name, row in want[group].items():
            for field, v in row.items():
                assert got[group][name][field] == pytest.approx(v, rel=1e-12)
    assert res["kernel_calls"]["flash_attention"] == 2 * cfg.n_layers
    assert "cost_probed" not in res
    assert res["memory"]["probe_peak_bytes"] is None       # no card


def test_a_cell_whose_arguments_exceed_the_card_is_not_run(monkeypatch):
    """Per-device arguments above the card's bytes: the cell says so and
    no probe runs (no wire bytes)."""
    monkeypatch.setitem(DL.HW, "hbm_bytes", 1e5)
    res = DL.analyze_cell("smollm-135m", SMALL_TRAIN, "cpu",
                          cfg=get_arch("smollm-135m").smoke,
                          mesh=make_abstract_mesh((2, 2), ("data", "model"),
                                                  "cpu"))
    assert not res["memory"]["fits"] and res["memory"]["cards_needed"] > 1
    assert "does not fit" in res["probe"] and "collectives" not in res


def test_dryrun_cli_writes_the_production_meshes_cells(tmp_path):
    """`dryrun --mesh single|multi --smoke true --device cpu` writes
    ``single_pod/<cell>.json`` (with the probed FLOPs) and
    ``multi_pod/<cell>.json`` (memory and wire bytes); `--mesh card`
    still writes ``single_card/``."""
    args = ["--smoke", "true", "--device", "cpu", "--arch", "smollm-135m",
            "--shape", "decode_32k", "--save-dir", str(tmp_path)]
    assert dryrun.main(["--mesh", "both"] + args) == 0
    single = json.loads((tmp_path / "single_pod" /
                         "smollm-135m__decode_32k.json").read_text())
    multi = json.loads((tmp_path / "multi_pod" /
                        "smollm-135m__decode_32k.json").read_text())
    assert single["devices"] == 256 and multi["devices"] == 512
    assert single["mesh"]["abstract"] and "cost_probed" in single
    assert "cost_probed" not in multi and "collectives" in multi
    for res in (single, multi):
        assert res["collectives"]["total_wire_bytes"] > 0
        assert res["memory"]["argument_bytes"] == DL.mesh_memory_stats(
            get_arch("smollm-135m").smoke, "decode_32k",
            res["mesh"]["axes"], 80e9)["argument_bytes"]
    assert dryrun.main(["--probes", "false"] + args) == 0
    assert (tmp_path / "single_card" / "smollm-135m__decode_32k.json"
            ).exists()
    rows = roofline.load_cells(str(tmp_path), "single_pod")
    assert [r["arch"] for r in rows] == ["smollm-135m"]
    assert roofline.roofline_row(rows[0])["collective_s"] == \
        roofline.axis_seconds(single["collectives"]["per_axis"])


# ---------------------------------------------------------------------------
# The hill-climber
# ---------------------------------------------------------------------------

def _variant_calls(path: Path) -> dict:
    """{key: ast.dump of the lambda's call} of a module's VARIANTS."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "VARIANTS"):
            return {ast.literal_eval(k): ast.dump(v.body)
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError(f"no VARIANTS in {path}")


def test_variants_are_the_references():
    """The 22 variants, each lambda calling `run_variant` with the
    reference's arguments (read with ast: importing the reference's
    module sets XLA_FLAGS); PURE_DP and SERVE_TP the reference's."""
    want = _variant_calls(SRC / "repro" / "launch" / "hillclimb.py")
    got = _variant_calls(SRC / "repro_torch" / "launch" / "hillclimb.py")
    assert len(want) == 22 and list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key
    assert set(hillclimb.VARIANTS) == set(want)
    rules = R.reference_rule_sets()
    assert (hillclimb.PURE_DP, hillclimb.SERVE_TP) == (rules["PURE_DP"],
                                                       rules["SERVE_TP"])


def test_run_variant_writes_its_record_at_a_smoke_config(tmp_path):
    """B1's lever (PURE_DP, probes) at SmolLM's smoke config on an
    abstract (4, 2) mesh: the JSON has the reference's keys where they
    have a counterpart; "model" is a batch axis there, so only
    all-reduces cross it."""
    res = hillclimb.run_variant("B1_pure_dp", "smollm-135m", SMALL_TRAIN,
                                rules_override=hillclimb.PURE_DP,
                                probes=True, mesh_shape=(4, 2), smoke=True,
                                device="cpu", out_dir=str(tmp_path))
    path = tmp_path / "smollm-135m__train_4k__B1_pure_dp.json"
    saved = json.loads(path.read_text())
    for key in ("variant", "cfg_kw", "rules_override", "microbatch",
                "memory", "collectives", "model_flops_global",
                "collective_s", "cost_probed"):
        assert key in saved, key
    assert saved["rules_override"]["batch"] == ["pod", "data", "model"]
    assert {"argument_bytes", "probe_peak_bytes"} <= set(saved["memory"])
    assert {"per_kind", "per_axis"} <= set(saved["collectives"])
    model = res["collectives"]["per_axis"]["model"]
    assert model["all-reduce"] == model["wire_bytes"] > 0
    assert saved["collective_s"] == roofline.axis_seconds(
        saved["collectives"]["per_axis"])


def test_main_runs_every_variant_and_reports_a_failure(tmp_path,
                                                       monkeypatch):
    """`main --only`: each variant prints its line; one that raises
    prints FAIL, the rest still run, and the exit code is 1."""
    ran = []
    monkeypatch.setattr(hillclimb, "VARIANTS", {
        "X1": lambda: ran.append("X1"),
        "X2": lambda: 1 / 0,
        "X3": lambda: ran.append("X3")})
    assert hillclimb.main(["--only", "X1,X2,X3", "--smoke", "true",
                           "--device", "cpu"]) == 1
    assert ran == ["X1", "X3"]
    assert hillclimb.main(["--only", "X1"]) == 0
    assert hillclimb.main(["--only", "nope"]) == 2
    assert hillclimb._RUN["smoke"] is False          # restored


# ---------------------------------------------------------------------------
# The roofline's links
# ---------------------------------------------------------------------------

def test_collective_seconds_take_each_axis_over_its_link():
    """A group inside one 8-card host goes over NVLink (450 GB/s a
    direction), one that spans hosts over the 50 GB/s NDR port; the
    16-wide model axis of 16x16 spans two hosts. `collective_seconds`
    keeps its meaning (all bytes over NVLink, 0.0 on one device)."""
    rows = {"model": {"n": 16, "stride": 1, "wire_bytes": 50e9},
            "data": {"n": 16, "stride": 16, "wire_bytes": 100e9},
            "in_host": {"n": 4, "stride": 2, "wire_bytes": 450e9},
            "eight": {"n": 8, "stride": 1, "wire_bytes": 900e9},
            "odd": {"n": 3, "stride": 1, "wire_bytes": 5e9},
            "single": {"n": 1, "stride": 1, "wire_bytes": 1e12}}
    assert roofline.link_bandwidth(8, 1) == roofline.NVLINK_BW == 450e9
    assert roofline.link_bandwidth(16, 1) == roofline.INTER_HOST_BW == 50e9
    assert roofline.link_bandwidth(2, 4) == 450e9
    assert roofline.link_bandwidth(2, 8) == 50e9
    assert roofline.axis_seconds(rows) == pytest.approx(
        1.0 + 2.0 + 1.0 + 2.0 + 0.1)
    assert roofline.collective_seconds(450e9, 4) == 1.0
    assert roofline.collective_seconds(450e9, 1) == 0.0


# ---------------------------------------------------------------------------
# Per-device argument bytes against the reference's compiled ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(R.ARGBYTES_MESHES))
@pytest.mark.parametrize("arch,shape,rules", R.ARGBYTES_CASES)
def test_argument_bytes_equal_the_references(arch, shape, rules, mesh_name,
                                             ref_argbytes):
    """`mesh_memory_stats` on an abstract mesh of the reference's test
    shape, at the smoke config, equals the reference's
    ``memory_stats(lower_and_compile(...)[0])["argument_bytes"]``
    exactly (where OLMoE's step does not compile under a hill-climb
    override, the reference's own arguments and shardings compiled
    alone)."""
    sizes, names = R.ARGBYTES_MESHES[mesh_name]
    mesh = make_abstract_mesh(sizes, names, "cpu")
    rule = R.reference_rule_sets()[rules]
    with SH.rules_ctx(rule):
        got = DL.mesh_memory_stats(get_arch(arch).smoke, shape, mesh, 80e9)
    want = ref_argbytes[mesh_name][f"{arch}|{shape}|{rules}"]
    assert got["argument_bytes"] == want["argument_bytes"], want["compiled"]
