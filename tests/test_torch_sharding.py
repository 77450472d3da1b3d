"""The port's logical-axis rules and collective accounting against the
reference's, in this process (no process group): `logical_to_pspec`
for every leaf of every config's parameters, train state and inputs on
the reference's test meshes, with and without the hill-climber's rule
overrides (the port's `launch.hillclimb` tables, held equal to the
reference's source); the ring cost model and HLO type sizes of
`launch/collectives.py` against `launch/hlo_analysis.py`'s."""
import ast
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import Mesh as JaxMesh  # noqa: E402

from repro.config import SHAPES as REF_SHAPES  # noqa: E402
from repro.config import OptimizerConfig as RefOptCfg  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.launch import hlo_analysis as REF_HLO  # noqa: E402
from repro.models import sharding as REF_SH  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.train import loop as REF_TL  # noqa: E402

from repro_torch.config import SHAPES, MeshConfig, OptimizerConfig  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.launch import collectives as COLL  # noqa: E402
from repro_torch.launch import hillclimb as HC  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402

HILLCLIMB = (Path(__file__).resolve().parents[1] / "src" / "repro" / "launch"
             / "hillclimb.py")


def _hillclimb_tables() -> dict:
    """PURE_DP and SERVE_TP as the reference's hill-climber defines them,
    read from its source (importing it would set XLA_FLAGS for the whole
    process)."""
    out = {}
    for node in ast.parse(HILLCLIMB.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in ("PURE_DP", "SERVE_TP"):
                out[name] = ast.literal_eval(node.value)
    assert set(out) == {"PURE_DP", "SERVE_TP"}
    return out


RULE_SETS = {"default": None, "PURE_DP": HC.PURE_DP,
             "SERVE_TP": HC.SERVE_TP}


def test_hillclimb_rule_sets_equal_the_references():
    """The port's hill-climber defines PURE_DP and SERVE_TP as the
    reference's does."""
    assert _hillclimb_tables() == {"PURE_DP": HC.PURE_DP,
                                   "SERVE_TP": HC.SERVE_TP}
MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((16, 16), ("data", "model"))]


def _fake_mesh(shape, axes):
    """The reference's test mesh (`tests/test_sharding_and_hlo.py`): one
    CPU device repeated."""
    devs = np.array([jax.devices()[0]] * int(np.prod(shape))).reshape(shape)
    return JaxMesh(devs, axes)


def _port_mesh(shape, axes) -> dict:
    return dict(zip(axes, shape))


def _as_tuples(tree) -> dict:
    return {p: tuple(s) for p, s in flatten(tree)}


def _with_rules(rules, fn):
    with REF_SH.rules_ctx(rules), SH.rules_ctx(rules):
        return fn()


@pytest.mark.parametrize("rules", list(RULE_SETS))
@pytest.mark.parametrize("arch", list_archs())
def test_pspecs_equal_the_references_for_every_leaf(arch, rules):
    """Every leaf of `Model.specs()` and of `train.loop.state_specs`
    (with int8 error feedback), and every input of every shape, at the
    published widths, maps to the reference's PartitionSpec (as a tuple
    of axis names) on the four test meshes."""
    cfg, ref_cfg = get_arch(arch).full, ref_get_arch(arch).full
    model, ref = get_model(cfg), ref_get_model(ref_cfg)
    opt, ref_opt = OptimizerConfig(compression="int8"), RefOptCfg(
        compression="int8")
    n = 0
    for shape, axes in MESHES:
        jm, pm = _fake_mesh(shape, axes), _port_mesh(shape, axes)
        got = _with_rules(RULE_SETS[rules], lambda: {
            "params": _as_tuples(model.pspecs(pm)),
            "state": _as_tuples(TL.state_pspecs(model, opt, pm)),
            **{f"in_{s}": _as_tuples(model.input_pspecs(SHAPES[s], pm))
               for s in SHAPES}})
        want = _with_rules(RULE_SETS[rules], lambda: {
            "params": _as_tuples(ref.pspecs(jm)),
            "state": _as_tuples(REF_TL.state_pspecs(ref, ref_opt, jm)),
            **{f"in_{s}": _as_tuples(ref.input_pspecs(REF_SHAPES[s], jm))
               for s in REF_SHAPES}})
        assert got.keys() == want.keys()
        for what in want:
            assert got[what] == want[what], (arch, rules, shape, what)
            n += len(want[what])
    assert n > 0


def test_divisibility_drop_reuse_and_unwrap_match_the_reference():
    """The reference's own cases (`tests/test_sharding_and_hlo.py`)."""
    m = {"data": 2, "model": 4}
    assert SH.logical_to_pspec(("batch", "tp"), (8, 12), m) == (
        "data", "model")
    assert SH.logical_to_pspec(("batch", "tp"), (1, 12), m) == (None, "model")
    assert SH.logical_to_pspec(("batch", "tp"), (8, 3), m) == ("data", None)
    assert SH.logical_to_pspec(("tp", "tp"), (8, 8), m) == ("model", None)
    pod = MeshConfig(data=2, model=2, pod=2)
    assert SH.logical_to_pspec(("batch", None), (8, 4), pod) == (
        ("pod", "data"), None)
    assert SH.logical_to_pspec(("batch", None), (2, 4), pod) == ("pod", None)


def test_tree_pspecs_equals_the_references():
    """`tree_pspecs` over a tree of logical axes and shapes."""
    axes = {"a": ("batch", "tp"), "b": {"c": ("fsdp", None, "sp")}}
    shapes = {"a": (8, 12), "b": {"c": (16, 3, 4)}}
    jm = _fake_mesh((2, 2), ("data", "model"))
    want = REF_SH.tree_pspecs(axes, shapes, jm)
    got = SH.tree_pspecs(axes, shapes, {"data": 2, "model": 2})
    assert _as_tuples(got) == _as_tuples(want)


def test_placements_name_the_sharded_dimension_per_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard
    m = {"pod": 2, "data": 2, "model": 2}
    assert SH.to_placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert SH.to_placements((None, "model"), m) == (
        Replicate(), Replicate(), Shard(1))


def test_constrain_is_a_no_op_outside_a_mesh():
    import torch
    x = torch.ones(2, 3)
    assert SH.constrain(x, ("batch", "tp")) is x


@pytest.mark.parametrize("kind", COLL.COLLECTIVE_KINDS)
def test_wire_bytes_equal_the_references(kind):
    for n in (1, 2, 3, 4, 8, 16, 256):
        for b in (0, 4, 1000, 3 * 2**20):
            assert COLL._wire_bytes(kind, b, n) == REF_HLO._wire_bytes(
                kind, b, n), (n, b)


@pytest.mark.parametrize("type_str", [
    "f32[8]", "bf16[4,128,64]", "(f32[8], s32[])", "pred[3,3]",
    "(bf16[2,2], f8e4m3fn[16], c64[1])", "u8[]", "token[]"])
def test_shape_bytes_equal_the_references(type_str):
    assert COLL._shape_bytes(type_str) == REF_HLO._shape_bytes(type_str)


def test_counter_records_only_while_on():
    """A collective issued outside ``COUNTER.on()`` is not recorded; one
    inside is, with its mesh axis and group stride, and its ring wire
    bytes in the summary by kind and by axis."""
    import torch
    COLL.COUNTER.reset()
    SH._record("all-gather", torch.ones(16), 4, "data", 2)
    assert COLL.COUNTER.records == []
    with COLL.COUNTER.on():
        SH._record("all-gather", torch.ones(16), 4, "data", 2)
    assert not COLL.COUNTER.enabled
    assert COLL.COUNTER.records == [("all-gather", 64, 4, "data", 2)]
    assert COLL.COUNTER.summary() == {"per_kind": {"all-gather": {
        "count": 1, "result_bytes": 64, "wire_bytes": 48.0}},
        "per_axis": {"data": {"n": 4, "stride": 2, "count": 1,
                              "result_bytes": 64, "wire_bytes": 48.0,
                              "all-gather": 48.0}},
        "total_wire_bytes": 48.0}
    COLL.COUNTER.reset()
    with pytest.raises(ValueError):
        COLL.COUNTER.record("broadcast", 1, 2)


def test_mesh_entry_points_refuse_a_missing_card_or_group(monkeypatch):
    """A mesh asked for "cuda" raises where there is no card, and any mesh
    raises without a process group; neither falls back."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(MeshConfig(), "cuda")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(MeshConfig(), "cpu")


def test_moving_an_axis_between_dimensions_is_refused():
    """A layout change that needs an all-to-all is not ported: it raises
    rather than computing something else."""
    class _Mesh:
        names, sizes = ("data", "model"), {"data": 2, "model": 2}

        def size(self, a):
            return self.sizes[a]
    with pytest.raises(ValueError, match="all-to-all"):
        SH._plan(("model", None), (None, "model"), _Mesh())


CACHE_MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
                ((4, 1), ("data", "model"))]


@pytest.mark.parametrize("arch", list_archs())
def test_cache_pspecs_equal_the_references(arch):
    """`Model.cache_pspecs` of every family's decode cache (KV caches with
    their "kv_seq" sequence, SSM and RG-LRU states, Whisper's
    cross-attention memory), for the smoke and the published configs, at
    the decode_32k shape and at small batches and lengths that the mesh
    axes divide and do not, equals the reference's on (2, 2), (1, 4) and
    (4, 1)."""
    n = 0
    for which in ("smoke", "full"):
        model = get_model(getattr(get_arch(arch), which))
        ref = ref_get_model(getattr(ref_get_arch(arch), which))
        for shape, axes in CACHE_MESHES:
            jm, pm = _fake_mesh(shape, axes), _port_mesh(shape, axes)
            for batch, max_seq in ((128, 32768), (4, 24), (3, 21)):
                got = _as_tuples(model.cache_pspecs(batch, max_seq, pm))
                want = _as_tuples(ref.cache_pspecs(batch, max_seq, jm))
                assert got == want, (which, shape, batch, max_seq)
                n += len(want)
    assert n > 0


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b",
                                  "whisper-base"])
def test_unported_families_refuse_a_mesh(arch, monkeypatch):
    """The SSM, hybrid and encoder-decoder families, which refused a mesh
    (NotImplementedError) until their mesh paths were ported, now take
    one: `loss`, `prefill` and `decode` with a mesh hand it to the
    family's own `_mesh_loss`, `_mesh_prefill` and `_mesh_decode` (held
    on local shards against the reference's mesh paths in
    `tests/test_torch_mesh_families.py`), and none raises."""
    model = get_model(get_arch(arch).smoke)
    mesh = object()
    for name in ("_mesh_loss", "_mesh_prefill", "_mesh_decode"):
        monkeypatch.setattr(model.mod, name,
                            lambda *args, name=name: (name, args[-1]))
    assert model.loss({}, {}, mesh=mesh) == ("_mesh_loss", mesh)
    assert model.prefill({}, {}, mesh=mesh) == ("_mesh_prefill", mesh)
    assert model.decode({}, {}, None, mesh=mesh) == ("_mesh_decode", mesh)
