"""The port's single-card launch tooling against the reference's: the
analytic counts (`active_param_count`, `param_count`, `model_flops`) for
every architecture and cell, `apply_overrides` and `MeshConfig`, the
abstract trees, the kernels' cost formulas (the numbers `chip_smoke.py`
prints its bounds from) and their counter, the marginal-layer probes,
the memory stats and the roofline."""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import config as ref_config  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.registry import all_cells as ref_all_cells  # noqa: E402
from repro.launch import dryrun_lib as ref_dl  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.models.params import _path_str  # noqa: E402

from repro_torch import config as port_config  # noqa: E402
from repro_torch.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.configs.registry import all_cells  # noqa: E402
from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.kernels.cost import COUNTER  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import dryrun_lib as DL  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402

ARCHS = list_archs()
CELLS = [(a, s) for a, s, _ in all_cells()]


def test_registry_has_the_references_40_cells():
    assert [c for c in all_cells()] == [c for c in ref_all_cells()]
    assert len(CELLS) == 40
    assert sum(st == "run" for _, _, st in all_cells()) == 32


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_references(arch, size):
    cfg, ref = (getattr(get_arch(arch), size),
                getattr(ref_get_arch(arch), size))
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert get_model(cfg).param_count() == ref_get_model(ref).param_count()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_references(arch, shape):
    assert DL.model_flops(arch, shape) == ref_dl.model_flops(arch, shape)


# --- apply_overrides, MeshConfig ---------------------------------------------

OVERRIDES = [
    {"n_layers": "3", "rope_theta": "5e5", "qk_norm": "yes",
     "block_pattern": "rec,attn", "dtype": "float32"},
    {"tie_embeddings": "0", "capacity_factor": "2", "attn_impl": "ref"},
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_apply_overrides_on_model_configs(overrides):
    for arch in ("smollm-135m", "recurrentgemma-9b"):
        got = port_config.apply_overrides(get_arch(arch).smoke, overrides)
        want = ref_config.apply_overrides(ref_get_arch(arch).smoke, overrides)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a == b and type(a) is type(b), f.name


def test_apply_overrides_on_nested_train_configs():
    ov = {"optimizer.lr": "0.01", "optimizer.compression": "int8",
          "seq_len": "64", "remat": "full"}
    got = port_config.apply_overrides(port_config.TrainConfig(), ov)
    want = ref_config.apply_overrides(ref_config.TrainConfig(), ov)
    assert dataclasses.asdict(got.optimizer) == dataclasses.asdict(
        want.optimizer)
    assert (got.seq_len, got.remat) == (want.seq_len, want.remat)


@pytest.mark.parametrize("key", ["no_such_field", "n_layers.deeper",
                                 "optimizer.nope"])
def test_apply_overrides_raises_the_references_key_error(key):
    messages = []
    for mod, arch in ((port_config, get_arch), (ref_config, ref_get_arch)):
        target = (mod.TrainConfig() if key.startswith("optimizer")
                  else arch("smollm-135m").smoke)
        with pytest.raises(KeyError) as err:
            mod.apply_overrides(target, {key: "1"})
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "no config field" in messages[0]


@pytest.mark.parametrize("axes", [(1, 1, 1), (4, 2, 1), (16, 16, 2),
                                  (8, 1, 4)])
def test_mesh_config_as_the_references(axes):
    d, m, p = axes
    got = port_config.MeshConfig(data=d, model=m, pod=p)
    want = ref_config.MeshConfig(data=d, model=m, pod=p)
    assert got.n_devices == want.n_devices
    assert got.axis_names() == want.axis_names()
    assert got.shape() == want.shape()


# --- abstract trees ------------------------------------------------------------

def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in flat}


def _port_leaves(tree):
    out = {}
    for p, t in flatten(tree):
        assert t.device.type == "meta", p          # nothing allocated
        out[p] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_the_references(arch):
    got = _port_leaves(get_model(get_arch(arch).full).abstract())
    want = _ref_leaves(ref_get_model(ref_get_arch(arch).full).abstract())
    assert got == want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_abstract_cache_and_inputs_match_the_references(arch, shape):
    model = get_model(get_arch(arch).full)
    ref = ref_get_model(ref_get_arch(arch).full)
    sh, ref_sh = SHAPES[shape], ref_config.SHAPES[shape]
    assert _port_leaves(model.input_specs(sh)) == _ref_leaves(
        ref.input_specs(ref_sh))
    B, S = sh.global_batch, sh.seq_len
    assert _port_leaves(model.abstract_cache(B, S)) == _ref_leaves(
        ref.abstract_cache(B, S))


# --- the kernels' cost formulas --------------------------------------------------

# PERF.md §6's counts, which chip_smoke.py prints its bounds from
PINNED = [
    ("admission N 100k, R 3", lambda: cost.admission_rounds(100_000, 3, 3),
     (0, 4_500_048)),
    ("flash, phi4-mini prefill", lambda: cost.flash_attention(
        4, 2048, 2048, 24, 8, 128, 2, True, 0),
     (103_129_546_752, None)),
    ("SSD, Mamba-2 prefill", lambda: cost.ssd_scan(4, 2048, 80, 64, 128, 256,
                                                   2),
     (None, 185_074_304)),
    ("RG-LRU forward", lambda: cost.rglru_scan(4, 2048, 4096, 2),
     (None, 335_675_392)),
    ("RG-LRU backward", lambda: cost.rglru_scan_backward(2, 4096, 4096, 2),
     (None, 536_969_216)),
    ("SSD backward", lambda: cost.ssd_backward(2, 4096, 80, 64, 128, 256, 2),
     (130_459_631_616, None)),
]


@pytest.mark.parametrize("name,fn,want", PINNED, ids=[p[0] for p in PINNED])
def test_cost_formulas_reproduce_the_pinned_counts(name, fn, want):
    flops, nbytes = fn()
    if want[0] is not None:
        assert flops == want[0]
    if want[1] is not None:
        assert nbytes == want[1]


@pytest.mark.parametrize("case", [(7, 7, True, 0), (7, 7, True, 3),
                                  (5, 9, True, 0), (9, 5, True, 4),
                                  (6, 8, False, 0), (6, 8, False, 2)])
def test_attention_pairs_count_the_masks_kept_edges(case):
    from repro_torch.kernels.ref import _attn_mask
    Sq, Skv, causal, window = case
    mask = _attn_mask(Sq, Skv, 0, None, causal, window)
    assert cost.attention_pairs(Sq, Skv, causal, window) == int(mask.sum())


def _delta(fn):
    calls, flops, nbytes = (dict(COUNTER.calls), dict(COUNTER.flops),
                            dict(COUNTER.bytes))
    with COUNTER.on():
        fn()
    return ({k: COUNTER.calls[k] - calls[k] for k in calls},
            {k: COUNTER.flops[k] - flops[k] for k in flops},
            {k: COUNTER.bytes[k] - nbytes[k] for k in nbytes})


def test_cost_counter_counts_attention_on_the_plain_route():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g)
    k, v = (torch.randn(2, 40, 2, 16, generator=g) for _ in range(2))
    calls, flops, nbytes = _delta(lambda: ops.mha(q, k, v, window=9))
    want = cost.flash_attention(2, 40, 40, 4, 2, 16, 4, True, 9)
    assert calls["flash_attention"] == 1
    assert (flops["flash_attention"], nbytes["flash_attention"]) == want
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    calls, flops, nbytes = _delta(lambda: ops.mha(*leaves, causal=False))
    want = cost.flash_attention(2, 40, 40, 4, 2, 16, 4, False, 0, lse=True)
    assert (flops["flash_attention"], nbytes["flash_attention"]) == want
    # a decode row and the plain impl are not the kernel's calls
    calls, _, _ = _delta(lambda: ops.mha(q[:, :1], k, v, q_offset=39))
    calls2, _, _ = _delta(lambda: ops.mha(q, k, v, impl="ref"))
    assert not any(calls.values()) and not any(calls2.values())


def test_cost_counter_counts_ssd_and_rglru_on_the_plain_route():
    from repro_torch.kernels.rglru_scan import rglru_gated
    g = torch.Generator().manual_seed(1)
    B, S, H, P, N = 2, 32, 3, 8, 16
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.rand(B, S, H, generator=g)
    b, c = (torch.randn(B, S, 1, N, generator=g) for _ in range(2))
    a_log, d = torch.rand(H, generator=g), torch.ones(H)
    calls, flops, nbytes = _delta(lambda: ops.ssd(x, dt, a_log, b, c, d,
                                                  chunk=16))
    assert calls["ssd_scan"] == 1
    assert (flops["ssd_scan"], nbytes["ssd_scan"]) == cost.ssd_scan(
        B, S, H, P, N, 16, 4)
    xr, r, i = (torch.randn(2, 24, 8, generator=g) for _ in range(3))
    lam = torch.randn(8, generator=g)
    calls, flops, nbytes = _delta(lambda: ops.rglru(xr, r, i, lam))
    assert calls["rglru_scan"] == 1
    assert (flops["rglru_scan"], nbytes["rglru_scan"]) == cost.rglru_scan(
        2, 24, 8, 4)
    leaves = [t.clone().requires_grad_() for t in (xr, r, i, lam)]

    def fwd_bwd():
        h, h_last = rglru_gated(*leaves)
        (h.sum() + h_last.sum()).backward()
    calls, flops, nbytes = _delta(fwd_bwd)
    fwd, bwd = cost.rglru_scan(2, 24, 8, 4), cost.rglru_scan_backward(
        2, 24, 8, 4)
    assert calls["rglru_scan"] == 2
    assert flops["rglru_scan"] == fwd[0] + bwd[0]
    assert nbytes["rglru_scan"] == fwd[1] + bwd[1]


def test_cost_counter_counts_nothing_and_computes_no_cost_when_off():
    def no_work():
        raise AssertionError("the cost was computed with the counter off")
    assert not COUNTER.enabled
    with COUNTER.count("flash_attention", no_work):
        pass
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 24, 2, 8, generator=g) for _ in range(3))
    before = dict(COUNTER.calls)
    ops.mha(q, k, v)
    ops.rglru(q[..., 0, :], q[..., 1, :], k[..., 0, :], v[0, 0, 0])
    assert COUNTER.calls == before
    with COUNTER.on():
        with COUNTER.on():
            pass
        assert COUNTER.enabled
    assert not COUNTER.enabled


def test_cost_counter_counts_admission_rounds():
    from repro_torch.cluster.placement_kernel import admission_rounds
    N, R = 50, 3
    rng = np.random.default_rng(0)
    i32 = dict(dtype=torch.int32)
    args = (torch.as_tensor(rng.normal(size=(N, R))),
            torch.as_tensor(rng.integers(0, R, N), **i32),
            torch.ones(N, dtype=torch.bool), torch.full((N,), -1, **i32),
            torch.zeros(N, **i32), torch.full((R,), 5, **i32))
    calls, _, nbytes = _delta(lambda: admission_rounds(*args, R))
    assert calls["admission_round"] == 1
    assert nbytes["admission_round"] == cost.admission_rounds(N, R, R)[1]
    # no containers: the card launches nothing, so nothing counts
    empty = [a[:0] for a in args[:5]] + [args[5]]
    calls, _, _ = _delta(lambda: admission_rounds(*empty, R))
    assert not any(calls.values())


def test_count_cost_puts_the_formula_in_place_of_the_plain_ops():
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 24, 2, 8, generator=g)
    k, v = (torch.randn(1, 24, 2, 8, generator=g) for _ in range(2))
    got = DL.count_cost(ops.mha, q, k, v)
    flops, nbytes = cost.flash_attention(1, 24, 24, 2, 2, 8, 4, True, 0)
    assert got["aten_flops"] == 0 and got["aten_bytes"] == 0
    assert (got["flops"], got["bytes_accessed"]) == (flops, nbytes)
    assert got["kernel_calls"]["flash_attention"] == 1
    plain = DL.count_cost(lambda: ops.mha(q, k, v, impl="ref"))
    assert plain["kernel_flops"] == 0 and plain["aten_flops"] > 0


# --- marginal-layer probes --------------------------------------------------------

PROBE_CFGS = {
    "dense": lambda: dataclasses.replace(get_arch("smollm-135m").smoke,
                                         n_layers=3),
    "hybrid_trailing": lambda: dataclasses.replace(
        get_arch("recurrentgemma-9b").smoke, n_layers=8),
    "encdec": lambda: dataclasses.replace(get_arch("whisper-base").smoke,
                                          n_layers=3, n_enc_layers=2),
}
PROBE_SHAPES = {"train": ShapeConfig("t", 32, 3, "train"),
                "prefill": ShapeConfig("p", 48, 2, "prefill"),
                "decode": ShapeConfig("d", 40, 2, "decode")}


@pytest.mark.parametrize("kind", sorted(PROBE_SHAPES))
@pytest.mark.parametrize("family", sorted(PROBE_CFGS))
def test_probe_extrapolation_equals_a_direct_count(family, kind):
    cfg, shape = PROBE_CFGS[family](), PROBE_SHAPES[kind]
    cpu = torch.device("cpu")
    # the first call in a process makes a few one-time scalars
    DL._probe_once(cfg, shape, cpu, "none", 1)
    direct = DL._probe_once(cfg, shape, cpu, "none", 1)
    if kind == "train":
        direct = DL._combine([(shape.global_batch, direct["grads"]),
                              (1, direct["update"])])
    else:
        direct = DL._combine([(shape.global_batch, direct)])
    probed = DL.probe_cost("x", shape, "cpu", cfg=cfg, remat="none")
    assert probed["flops"] > 0
    for key in ("flops", "bytes_accessed", "kernel_flops", "kernel_bytes",
                "kernel_calls"):
        assert probed[key] == direct[key], key


def test_a_probe_that_does_not_fit_is_skipped_not_run():
    # DBRX's 2-layer train probe: 6.6 B expert and attention parameters
    # and 1.2 B of embeddings, 124 GB with f32 masters, AdamW and grads
    cfg = dataclasses.replace(get_arch("dbrx-132b").full, n_layers=2)
    mem = DL.memory_stats(cfg, "train_4k", 80e9, batch=1)
    assert mem["peak_bytes"] > 80e9 and mem["cards_needed"] == 2
    assert DL.probe_cost("dbrx-132b", "train_4k", "cpu",
                         hbm_bytes=80e9) is None


@pytest.mark.parametrize("arch,shape", [("smollm-135m", "train_4k"),
                                        ("dbrx-132b", "decode_32k"),
                                        ("mamba2-2.7b", "long_500k")])
def test_memory_stats_add_up_the_abstract_trees(arch, shape):
    cfg = get_arch(arch).full
    mem = DL.memory_stats(cfg, shape, 80e9)
    n = get_model(cfg).param_count()
    assert mem["params_bytes"] == 4 * n
    if SHAPES[shape].kind == "train":
        assert mem["opt_state_bytes"] == 8 * n and mem["grad_bytes"] == 4 * n
    else:
        assert mem["cache_bytes"] > 0
    parts = ("params_bytes", "opt_state_bytes", "grad_bytes", "cache_bytes",
             "input_bytes")
    assert mem["peak_bytes"] == sum(mem[k] for k in parts)
    assert mem["cards_needed"] == math.ceil(mem["peak_bytes"] / 80e9)


# --- train model FLOPs --------------------------------------------------------------

# chip_smoke.py's `_family_model_flops` before it moved, at phase 9's shapes
TRAIN_FLOPS = [("smollm-135m", None, 256, 4096, 1291706179780608.0),
               ("mamba2-2.7b", None, 8, 4096, 564746357047296.0),
               ("recurrentgemma-9b", 8, 8, 4096, 561628714106880.0),
               ("whisper-base", None, 64, 448, 26911418351616.0),
               ("phi4-mini-3.8b", None, 256, 4096, 2.666805538376909e+16)]


@pytest.mark.parametrize("arch,n_layers,batch,seq,want", TRAIN_FLOPS)
def test_train_model_flops_are_the_moved_formula(arch, n_layers, batch, seq,
                                                 want):
    cfg = get_arch(arch).full
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    assert DL.train_model_flops(get_model(cfg), batch, seq) == want


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "dbrx-132b"])
def test_train_model_flops_count_the_active_experts(arch):
    cfg = get_arch(arch).full
    dense = dataclasses.replace(cfg, n_experts=cfg.top_k)   # only the active
    got = DL.train_model_flops(get_model(cfg), 4, 512)
    tree = get_model(cfg).param_count()
    router = cfg.d_model * (cfg.n_experts - cfg.top_k) * cfg.n_layers
    want = DL.train_model_flops(get_model(dense), 4, 512) + 6.0 * router * 4 * 512
    assert tree > get_model(dense).param_count()
    assert got == want


# --- the CLI and the roofline -----------------------------------------------------------

def test_dryrun_cli_writes_one_json_per_cell(tmp_path):
    argv = ["--arch", "mamba2-2.7b", "--smoke", "true", "--device", "cpu",
            "--save-dir", str(tmp_path), "--probes", "false"]
    assert dryrun.main(argv) == 0
    rows = roofline.load_cells(str(tmp_path))
    assert [r["shape"] for r in rows] == list(SHAPES)
    smoke = get_arch("mamba2-2.7b").smoke
    for r in rows:
        assert r["status"] == "ok" and r["devices"] == 1
        assert r["model_flops_global"] == DL.model_flops("x", r["shape"],
                                                         smoke)
        assert "cost_probed" not in r
    assert dryrun.main(argv[:1] + ["chameleon-34b", "--shape", "long_500k"]
                       + argv[2:]) == 0
    skipped = json.loads(open(DL.cell_path(str(tmp_path), "chameleon-34b",
                                           "long_500k")).read())
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == ref_get_arch("chameleon-34b").skip_shapes[
        "long_500k"]
    assert roofline.main(["--save-dir", str(tmp_path)]) == 0
    assert (tmp_path / "roofline.json").exists()


def test_dryrun_cli_probes_a_smoke_cell(tmp_path):
    argv = ["--arch", "smollm-135m", "--shape", "decode_32k", "--smoke",
            "true", "--device", "cpu", "--save-dir", str(tmp_path)]
    assert dryrun.main(argv) == 0
    res = json.loads(open(DL.cell_path(str(tmp_path), "smollm-135m",
                                       "decode_32k")).read())
    assert res["params"] == get_model(get_arch("smollm-135m").smoke
                                      ).param_count()
    assert res["cost_probed"]["flops"] > 0


def test_a_probe_out_of_memory_fails_the_cell(tmp_path, monkeypatch):
    def oom(*args, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(DL, "probe_cost", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        DL.analyze_cell("smollm-135m", "decode_32k", "cpu")
    argv = ["--arch", "smollm-135m", "--shape", "decode_32k", "--smoke",
            "true", "--device", "cpu", "--save-dir", str(tmp_path)]
    assert dryrun.main(argv) == 1
    assert not (tmp_path / "single_card").exists()


def test_dryrun_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DL.analyze_cell("smollm-135m", "decode_32k")


def _cell(flops=2e12, nbytes=1e12, peak=50e9, status="ok", **kw):
    res = {"arch": "a", "shape": "train_4k", "status": status, "devices": 1,
           "model_flops_global": 1e12, "card_bytes": 80e9,
           "memory": {"peak_bytes": peak, "cards_needed": math.ceil(
               peak / 80e9)},
           "cost_probed": {"flops": flops, "bytes_accessed": nbytes}, **kw}
    return res


def test_roofline_row_math():
    r = roofline.roofline_row(_cell())
    assert r["compute_s"] == pytest.approx(2e12 / 989e12)
    assert r["memory_s"] == pytest.approx(1e12 / 3.35e12)
    assert r["collective_s"] == 0.0 and r["devices"] == 1
    assert r["dominant"] == "memory"
    assert r["useful_ratio"] == pytest.approx(0.5)
    assert r["roofline_fraction"] == pytest.approx(
        (1e12 / 989e12) / (1e12 / 3.35e12))
    assert r["fits_hbm"] and r["cards_needed"] == 1
    r = roofline.roofline_row(_cell(flops=1e15, nbytes=1e9, peak=200e9,
                                    train_model_flops=3e12), step_time_s=2.0)
    assert r["dominant"] == "compute" and not r["fits_hbm"]
    assert r["cards_needed"] == 3
    assert r["mfu"] == 3e12 / (2.0 * 989e12) and r["step_time_s"] == 2.0
    r = roofline.roofline_row(
        {**_cell(), "cost_probed": None, "probe": "does not fit one card"})
    assert "compute_s" not in r and r["probe"].startswith("does not fit")
    skipped = roofline.roofline_row({"arch": "a", "shape": "long_500k",
                                     "status": "skipped", "reason": "why"})
    table = roofline.markdown_table([r, skipped])
    assert table.count("\n") == 3 and "skipped" in table


@pytest.mark.parametrize("shape", list(SHAPES))
def test_build_cell_describes_the_cell_on_meta_tensors(shape):
    fn, args, meta = DL.build_cell("recurrentgemma-9b", shape, "cpu")
    assert callable(fn)
    assert all(t.device.type == "meta"
               for t in torch.utils._pytree.tree_leaves(args)
               if isinstance(t, torch.Tensor))
    assert meta["kind"] == SHAPES[shape].kind and meta["devices"] == 1
    assert meta["params"] == get_model(
        get_arch("recurrentgemma-9b").full).param_count()


def test_compare_phases_takes_turns_and_summarises(monkeypatch, tmp_path):
    from repro_torch.launch import compare_phases as CP
    seen = []

    def turn(tree, phases):
        assert phases == ["placed_sweep"]
        seen.append(tree.name)
        scale = 2.0 if tree.name == "b" else 1.0
        return {"placed_sweep": {"sweep_s": scale * (1 + len(seen))}}
    monkeypatch.setattr(CP, "_turn", turn)
    monkeypatch.chdir(tmp_path)
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
    assert CP.main(["a", "b", "--phases", "placed_sweep"]) == 0
    assert seen == ["a", "b", "b", "a"]
    out = json.loads((tmp_path / "chiprun_out" / "compare_phases.json")
                     .read_text())
    assert [m["placed_sweep"]["sweep_s"] for m in out["median"]] == [3.5, 7.0]
    assert out["ratio_to_first"][1]["placed_sweep"]["sweep_s"] == 2.0
