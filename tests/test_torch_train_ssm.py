"""Training of the recurrent families against the JAX reference, on the
CPU: Mamba-2 and RecurrentGemma smoke losses and gradients under each
remat policy, one AdamW train step, the SSD and RG-LRU scans under
autograd (`SSDScanFn`, `RGLRUScanFn`, whose CPU paths are the plain
versions) and the RG-LRU's plain reverse scan, checkpoints of their
train states read both ways, the carbon-aware trainer on Mamba-2 and
the training launcher. The reference's parameters
(`Model.init(PRNGKey(0))`) and train states are carried across by
`convert`; every other input is made with numpy from a seed. Tolerances
are stated in each test."""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.carbon.intensity import TraceProvider as RefTraceProvider  # noqa: E402
from repro.cluster.slices import Slice as RefSlice  # noqa: E402
from repro.cluster.slices import SliceFamily as RefSliceFamily  # noqa: E402
from repro.config import CarbonConfig as RefCarbonConfig  # noqa: E402
from repro.config import OptimizerConfig as RefOptCfg  # noqa: E402
from repro.config import TrainConfig as RefTrainCfg  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.carbon_aware_trainer import \
    CarbonAwareTrainer as RefTrainer  # noqa: E402
from repro.core.elastic import ElasticJob as RefJob  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.kernels import ref as REF_K  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.power.model import LinearPowerModel as RefLPM  # noqa: E402
from repro.train import checkpoint as REF_CKPT  # noqa: E402
from repro.train import loop as REF_TL  # noqa: E402

from repro_torch.carbon.intensity import TraceProvider  # noqa: E402
from repro_torch.cluster.slices import Slice, SliceFamily  # noqa: E402
from repro_torch.config import (CarbonConfig, OptimizerConfig,  # noqa: E402
                                TrainConfig)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import (from_reference_params,  # noqa: E402
                                 from_reference_state)
from repro_torch.core.carbon_aware_trainer import CarbonAwareTrainer  # noqa: E402
from repro_torch.core.elastic import ElasticJob  # noqa: E402
from repro_torch.data import pipeline as DATA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as K  # noqa: E402
from repro_torch.kernels.rglru_scan import (RGLRUScanFn,  # noqa: E402
                                            rglru_gated, rglru_scan,
                                            rglru_scan_torch)
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.power.model import LinearPowerModel  # noqa: E402
from repro_torch.train import checkpoint as CKPT  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402

ARCHS = ["mamba2-2.7b", "recurrentgemma-9b"]
REMATS = ["none", "full", "dots"]
# The SSD's decay parameters sum, over every position, products of
# exp(cumulative decay) differences that cancel: at the smoke config the
# reference's own float32 gradients of a_log and dt_bias are 1.17e-4 and
# 1.40e-5 of max |g| from the reference's loss evaluated in float64, the
# port's 2.5e-5 and 3.2e-6, the two 9.9e-5 and 1.2e-5 apart
# (`test_ssd_decay_gradients_are_float32_bound`). Those two leaves are
# held to a bar below the reference's own distance; every other leaf to
# 1e-5.
DECAY_TOL = {"layers/a_log": 1.1e-4, "layers/dt_bias": 1.3e-5}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _rel(got, want):
    """max |got - want| / max(max |want|, 1e-30), in float64."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_trees(got, want, tol, what, leaf_tol=None):
    """Every leaf of `got` (port) within `tol` (or its own bar in
    `leaf_tol`) of `want` (reference), relative to the leaf's max
    |want|; the same paths on both sides."""
    g = dict(flatten(got))
    w = dict(flatten(jax.tree.map(np.asarray, want)))
    assert set(g) == set(w), what
    bars = {p: (leaf_tol or {}).get(p, tol) for p in w}
    bad = {p: e for p, e in ((p, _rel(g[p], w[p])) for p in w) if e > bars[p]}
    assert not bad, f"{what}: {bad}"


def _pair(arch, dtype="float32"):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke, dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=dtype)
    ref = ref_get_model(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    params = from_reference_params(cfg, jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref, ref_params, get_model(cfg), params


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab[0, -3:] = -1                      # ignored positions
    return {"tokens": tok, "labels": lab}


# ---------------------------------------------------------------------------
# Losses, gradients and train steps of the smoke configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_the_reference_f32(arch, remat):
    """float32, both sides under the same remat policy: the loss and its
    ce_loss within 1e-5 relative, every gradient leaf within 1e-5 of the
    leaf's max |g|, Mamba-2's a_log and dt_bias within `DECAY_TOL` (S =
    48: three of Mamba-2's 16-step chunks; windows of 16 that bite in
    RecurrentGemma's attention)."""
    ref, ref_params, model, params = _pair(arch)
    batch = _batch(model.cfg, 2, 48, seed=1)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.loss(p, b, remat=remat), has_aux=True))(
        ref_params, jax.tree.map(jnp.asarray, batch))
    (loss, metrics), grads = TL._value_and_grad(
        model, remat, params, {k: torch.as_tensor(v) for k, v in
                               batch.items()})
    assert set(metrics) == set(rmet) == {"ce_loss"}
    assert _rel(loss, rloss) <= 1e-5
    assert _rel(metrics["ce_loss"], rmet["ce_loss"]) <= 1e-5
    _assert_trees(grads, rgrads, 1e-5, f"{arch} {remat} grads", DECAY_TOL)


# The reference's Mamba-2 smoke loss and gradients in float64, in a
# process of its own (x64 is global in JAX): every float32 cast of the
# reference made a float64 one, the parameters and batch read from argv[1]
# (an .npz), the loss and gradients written to argv[2].
F64_SCRIPT = """
import dataclasses, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from repro.configs import get_arch
from repro.models.api import get_model
jnp.float32 = jnp.float64
cfg = dataclasses.replace(get_arch("mamba2-2.7b").smoke, dtype="float64")
inp = dict(np.load(sys.argv[1]))
batch = {k: jnp.asarray(inp.pop(k)) for k in ("tokens", "labels")}
params = {}
for path, v in inp.items():
    *outer, leaf = path.split("/")
    node = params
    for k in outer:
        node = node.setdefault(k, {})
    node[leaf] = jnp.asarray(v, jnp.float64)
(loss, _), grads = jax.jit(jax.value_and_grad(
    lambda p, b: get_model(cfg).loss(p, b), has_aux=True))(params, batch)
out = {"/".join(k.key for k in kp): np.asarray(v)
       for kp, v in jax.tree_util.tree_leaves_with_path(grads)}
np.savez(sys.argv[2], loss=np.asarray(loss), **out)
"""


def test_ssd_decay_gradients_are_float32_bound(tmp_path):
    """Why `DECAY_TOL`: Mamba-2 smoke's gradients from the reference
    (float32, jit) and from the port (float32), each against the
    reference's own loss evaluated in float64 (`F64_SCRIPT`, an
    evaluation the port takes no part in). Every gradient is float64
    there; the two float32 losses are within 1e-6 of its loss. The
    reference's a_log and dt_bias are at least their `DECAY_TOL` from
    it (so the bar is no looser than the reference's own error), the
    port's no farther than the reference's, and every other leaf of
    both within 1e-5; the two float32 gradients within `DECAY_TOL` of
    each other."""
    import os
    import subprocess
    import sys
    ref, ref_params, model, params = _pair("mamba2-2.7b")
    batch = _batch(model.cfg, 2, 48, seed=1)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.loss(p, b), has_aux=True))(
        ref_params, jax.tree.map(jnp.asarray, batch))
    (loss, _), grads = TL._value_and_grad(
        model, "none", params, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
    np.savez(tmp_path / "in.npz", **batch,
             **dict(flatten(jax.tree.map(np.asarray, ref_params))))
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [src, os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, "-c", F64_SCRIPT, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], env=env, check=True,
                   timeout=300)
    t = dict(np.load(tmp_path / "out.npz"))
    loss64 = float(t.pop("loss"))
    r, g = dict(flatten(jax.tree.map(np.asarray, rgrads))), dict(flatten(grads))
    assert set(t) == set(g) == set(r)
    assert all(v.dtype == np.float64 for v in t.values())
    for got in (float(rloss), float(loss)):
        assert abs(got - loss64) <= 1e-6 * abs(loss64)
    for path, truth in t.items():
        theirs, port = _rel(r[path], truth), _rel(g[path], truth)
        if path in DECAY_TOL:
            assert theirs >= DECAY_TOL[path] and port <= theirs, (
                path, port, theirs)
            assert _rel(g[path], r[path]) <= DECAY_TOL[path], path
        else:
            assert max(theirs, port) <= 1e-5, (path, port, theirs)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_the_reference(arch):
    """One AdamW step of `make_train_step` (2 microbatches of 2, remat
    "full") from the reference's state (carried over by
    `from_reference_state`): the params, m and v within 1e-5 (allclose,
    absolute and relative), the loss within 1e-5 relative, the step
    counter equal."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke, dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
    opt_kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    tkw = dict(seq_len=32, global_batch=4, microbatch=2, remat="full")
    ref_model = ref_get_model(ref_cfg)
    ref_state = REF_TL.init_state(ref_model, RefOptCfg(**opt_kw),
                                  jax.random.PRNGKey(0))
    state = from_reference_state(cfg, jax.tree.map(np.asarray, ref_state),
                                 "cpu")
    batch = next(iter(DATA.SyntheticLM(cfg.vocab_size, 32, 4, seed=5)))
    ref_state, rmet = jax.jit(REF_TL.make_train_step(
        ref_model, RefTrainCfg(**tkw, optimizer=RefOptCfg(**opt_kw))))(
        ref_state, jax.tree.map(jnp.asarray, batch))
    state, met = TL.make_train_step(get_model(cfg), TrainConfig(
        **tkw, optimizer=OptimizerConfig(**opt_kw)))(
        state, DATA.to_device(batch, "cpu"))
    assert _rel(met["loss"], rmet["loss"]) <= 1e-5
    assert int(state["step"]) == int(ref_state["step"]) == 1
    want = dict(flatten(jax.tree.map(np.asarray, ref_state)))
    for path, got in flatten({k: state[k] for k in ("params", "opt")}):
        np.testing.assert_allclose(got.numpy(), want[path], atol=1e-5,
                                   rtol=1e-5, err_msg=path)


# ---------------------------------------------------------------------------
# The SSD scan under autograd
# ---------------------------------------------------------------------------

# tests/test_kernels.py's SSD cases (B, S, H, P, N, chunk), then one long
# chunk of large steps: a = -16, dt > 2, so exp(cum_q - cum_k) above the
# diagonal overflows to inf (selected away, never multiplied by 0)
SSD_CASES = [(2, 64, 4, 16, 32, 16, False), (1, 128, 8, 32, 64, 32, False),
             (2, 96, 4, 64, 16, 32, False), (1, 256, 2, 16, 32, 256, True)]


def _ssd_inputs(B, S, H, P, N, overflow, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    a_log = rng.uniform(0.0, 1.5, H).astype(np.float32)
    if overflow:
        dt, a_log = dt + 2.0, np.full(H, np.log(16.0), np.float32)
    return (f(B, S, H, P), dt, a_log, f(B, S, 1, N), f(B, S, 1, N),
            rng.uniform(0.5, 1.5, H).astype(np.float32)), (
        f(B, S, H, P), f(B, H, P, N))


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_scan_fn_grads_equal_autograd_through_ssd_chunked(case, with_dh):
    """`SSDScanFn` on the CPU (forward: the plain version; backward:
    `ssd_chunked_bwd_torch`) against autograd through `ssd_chunked` in
    the port, bit for bit (the same float32 graph), and against JAX's
    autodiff of the reference's `ssd_chunked`: y, h_final and the six
    gradients within 1e-5 of each one's max |g| (1e-4 for the
    overflowing case, whose cumulative decays reach the 1e4s), all
    finite. Without ``with_dh`` h_final's gradient is missing (zero)."""
    B, S, H, P, N, Q, overflow = case
    arrs, (dy, dh) = _ssd_inputs(B, S, H, P, N, overflow, seed=sum(case[:6]))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs]
    y, h = SSDScanFn.apply(*leaves, Q)
    outs, cots = ([y, h], [torch.tensor(dy), torch.tensor(dh)]) if with_dh \
        else ([y], [torch.tensor(dy)])
    got = torch.autograd.grad(outs, leaves, cots)
    plain = [torch.tensor(a, requires_grad=True) for a in arrs]
    py, ph = K.ssd_chunked(*plain, chunk=Q)
    want = torch.autograd.grad([py, ph][:len(outs)], plain, cots)
    assert torch.equal(y, py) and torch.equal(h, ph)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert bool(torch.isfinite(g).all())

    def ref_fn(*a):
        yy, hh = REF_K.ssd_chunked(*a, chunk=Q)
        return (yy, hh) if with_dh else yy
    rout, vjp = jax.vjp(ref_fn, *map(jnp.asarray, arrs))
    ry = rout[0] if with_dh else rout
    rgrads = vjp((jnp.asarray(dy), jnp.asarray(dh)) if with_dh
                 else jnp.asarray(dy))
    tol = 1e-4 if overflow else 1e-5
    assert _rel(y, ry) <= tol
    for name, g, w in zip(("x", "dt", "a_log", "b", "c", "d"), got, rgrads):
        assert _rel(g, w) <= tol, name


def test_ssd_scan_fn_bf16_grads_follow_the_reference():
    """bfloat16 x, b, c (float32 dt, a_log, d): the gradients come back in
    the inputs' dtypes and within 1e-2 of max |g| of JAX's autodiff of
    `ssd_chunked` on the same bf16 inputs (both differentiate in float32
    and round the x, b, c gradients to bf16)."""
    arrs, (dy, _) = _ssd_inputs(2, 64, 4, 16, 32, False, seed=11)
    cast = (True, False, False, True, True, False)
    leaves = [torch.tensor(a, dtype=torch.bfloat16 if c else torch.float32,
                           requires_grad=True) for a, c in zip(arrs, cast)]
    y, _ = SSDScanFn.apply(*leaves, 16)
    got = torch.autograd.grad(y, leaves, torch.tensor(dy).to(torch.bfloat16))
    assert [g.dtype for g in got] == [t.dtype for t in leaves]
    jin = [jnp.asarray(a, jnp.bfloat16 if c else jnp.float32)
           for a, c in zip(arrs, cast)]
    _, vjp = jax.vjp(lambda *a: REF_K.ssd_chunked(*a, chunk=16)[0], *jin)
    for g, w in zip(got, vjp(jnp.asarray(dy, jnp.bfloat16))):
        assert _rel(g, w) <= 1e-2


def test_raw_wrappers_keep_their_guard_and_ops_train_on_the_cpu():
    """On the CPU the raw wrappers run their plain versions (which carry
    a grad_fn); `ops.ssd` and `ops.rglru` take the reference's CPU paths
    (`ssd_chunked`, `rglru_assoc`) under plain autograd, within 1e-6 of
    the Functions' gradients."""
    arrs, (dy, _) = _ssd_inputs(1, 32, 2, 16, 16, False, seed=3)
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs]
    y, _ = ssd_scan(*leaves, chunk=16)
    assert y.grad_fn is not None
    y2, _ = ops.ssd(*leaves, chunk=16)
    g_ops = torch.autograd.grad(y2, leaves, torch.tensor(dy))
    g_fn = torch.autograd.grad(SSDScanFn.apply(*leaves, 16)[0], leaves,
                               torch.tensor(dy))
    for a, b in zip(g_ops, g_fn):
        assert _rel(a, b) <= 1e-6
    x, r, i, lam, h0, dh = _rglru_inputs(2, 24, 16, seed=4)
    leaves = [torch.tensor(t, requires_grad=True) for t in (x, r, i, lam)]
    hs, _ = ops.rglru(*leaves, h0=torch.tensor(h0))
    g_ops = torch.autograd.grad(hs, leaves, torch.tensor(dh))
    g_fn = torch.autograd.grad(rglru_gated(*leaves, h0=torch.tensor(h0))[0],
                               leaves, torch.tensor(dh))
    for a, b in zip(g_ops, g_fn):
        assert _rel(a, b) <= 1e-6


# ---------------------------------------------------------------------------
# The RG-LRU scan under autograd
# ---------------------------------------------------------------------------

RGLRU_CASES = [(2, 64, 128), (1, 128, 256), (3, 32, 512), (2, 37, 100)]


def _rglru_inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(B, S, W), f(B, S, W), f(B, S, W), f(W), f(B, W), f(B, S, W)


@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
def test_rglru_scan_bwd_torch_equals_autograd_of_the_plain_scan(case,
                                                                a_dtype):
    """The plain reverse scan's (da, dgx, dh0), with an h0 and a gradient
    of the last state, against autograd through `rglru_scan_torch`:
    within 1e-6 of each one's max |g| (da rounded to a's dtype on both
    sides); and `RGLRUScanFn` on the CPU returns exactly them."""
    B, S, W = case
    rng = np.random.default_rng(sum(case))
    a = torch.tensor(rng.uniform(0.0, 1.0, (B, S, W)).astype(np.float32)
                     ).to(a_dtype).requires_grad_()
    gx, h0, dy, dh_last = (torch.tensor(rng.normal(size=s).astype(np.float32),
                                        requires_grad=rg)
                           for s, rg in (((B, S, W), True), ((B, W), True),
                                         ((B, S, W), False), ((B, W), False)))
    hs, hl = rglru_scan_torch(a, gx, h0)
    want = torch.autograd.grad([hs, hl], [a, gx, h0], [dy, dh_last])
    got = K.rglru_scan_bwd_torch(a.detach(), hs.detach(), h0.detach(), dy,
                                 dh_last)
    assert got[0].dtype == a_dtype
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-6
    fhs, fhl = RGLRUScanFn.apply(a, gx, h0)
    fn = torch.autograd.grad([fhs, fhl], [a, gx, h0], [dy, dh_last])
    for g, w in zip(fn, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", RGLRU_CASES[:3], ids=str)
def test_rglru_gated_grads_equal_the_references(case):
    """`rglru_gated` under grad (gates by plain autograd, the scan through
    `RGLRUScanFn`) in float32 against autograd through the port's
    `rglru_ref` and JAX's autodiff of the reference's `rglru_assoc` (its
    CPU path): dx, dr, di, dlam and dh0 within 1e-5 of each one's max
    |g| (h_seq and h_final both carrying a gradient)."""
    x, r, i, lam, h0, dh = _rglru_inputs(*case, seed=sum(case))
    dl = np.random.default_rng(1).normal(size=h0.shape).astype(np.float32)
    cots = [torch.tensor(dh), torch.tensor(dl)]
    leaves = [torch.tensor(t, requires_grad=True) for t in (x, r, i, lam, h0)]
    hs, hl = rglru_gated(*leaves[:4], h0=leaves[4])
    got = torch.autograd.grad([hs, hl], leaves, cots)
    plain = [torch.tensor(t, requires_grad=True) for t in (x, r, i, lam, h0)]
    ps, pl = K.rglru_ref(*plain[:4], h0=plain[4])
    want = torch.autograd.grad([ps, pl], plain, cots)
    _, vjp = jax.vjp(lambda x, r, i, lam, h0: REF_K.rglru_assoc(
        x, r, i, lam, h0=h0), *map(jnp.asarray, (x, r, i, lam, h0)))
    rgrads = vjp((jnp.asarray(dh), jnp.asarray(dl)))
    for name, g, w, rw in zip(("x", "r", "i", "lam", "h0"), got, want,
                              rgrads):
        errs = {"rglru_ref": _rel(g, w), "rglru_assoc": _rel(g, rw)}
        assert max(errs.values()) <= 1e-5, (name, errs)


def test_rglru_raw_wrapper_raises_only_on_the_card():
    """The raw `rglru_scan` on a CPU tensor under grad runs the plain
    version (its graph intact); the guard is for the card."""
    a = torch.rand(1, 8, 16, requires_grad=True)
    hs, _ = rglru_scan(a, torch.zeros(1, 8, 16), torch.zeros(1, 16))
    assert hs.grad_fn is not None


# ---------------------------------------------------------------------------
# Checkpoints, the trainer, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_checkpoints_read_both_ways(arch, tmp_path):
    """A smoke train state the port writes reads into the reference bit
    for bit (leaf by leaf, the reference's `abstract_state` shapes), and
    one the reference writes reads into the port's `abstract_state` bit
    for bit."""
    ref_cfg = ref_get_arch(arch).smoke
    cfg = get_arch(arch).smoke
    model, ref_model = get_model(cfg), ref_get_model(ref_cfg)
    opt, ref_opt = OptimizerConfig(), RefOptCfg()
    state = TL.init_state(model, opt, 3, "cpu")
    CKPT.save(str(tmp_path / "port"), state, step=4)
    got = REF_CKPT.load(str(tmp_path / "port"),
                        REF_TL.abstract_state(ref_model, ref_opt))
    got = dict(flatten(jax.tree.map(np.asarray, got)))
    ours = dict(flatten(state))
    assert set(got) == set(ours)
    for path, t in ours.items():
        assert np.array_equal(t.numpy(), got[path]), path
    ref_state = REF_TL.init_state(ref_model, ref_opt, jax.random.PRNGKey(1))
    REF_CKPT.save(str(tmp_path / "ref"), ref_state, step=6)
    back = CKPT.load(str(tmp_path / "ref"), TL.abstract_state(model, opt),
                     "cpu")
    want = dict(flatten(jax.tree.map(np.asarray, ref_state)))
    for path, t in flatten(back):
        assert t.dtype == ours[path].dtype
        assert np.array_equal(t.numpy(), want[path]), path


TRAINER_SCENARIO = ([400.0, 800.0, 2000.0, 100.0] * 12, 40.0, 600.0, 16)


def test_carbon_aware_trainer_on_mamba2_equals_the_reference():
    """`CarbonAwareTrainer` over an `ElasticJob` of Mamba-2 smoke on the
    scenario that cuts the duty, migrates, suspends and resumes: every
    interval log exactly equal to the reference's, the same migrations,
    and each interval's loss within 1e-5 relative (the restores carry
    Mamba-2's tree through the reference's checkpoint format)."""
    trace, target, sim_s, steps = TRAINER_SCENARIO
    outs, losses = [], []
    for ref in (True, False):
        cfg = (ref_get_arch if ref else get_arch)("mamba2-2.7b").smoke
        cfg = dataclasses.replace(cfg, dtype="float32")
        model = (ref_get_model if ref else get_model)(cfg)
        opt = (RefOptCfg if ref else OptimizerConfig)(warmup_steps=1,
                                                      total_steps=100)
        if ref:     # the state both jobs start from: PRNGKey(cfg.seed)
            start = REF_TL.init_state(model, opt, jax.random.PRNGKey(0))
        tcfg = (RefTrainCfg if ref else TrainConfig)(seq_len=16,
                                                     global_batch=4,
                                                     optimizer=opt)
        lpm, sl, fam = ((RefLPM, RefSlice, RefSliceFamily) if ref else
                        (LinearPowerModel, Slice, SliceFamily))
        slices = [sl("s1", 0.5, lpm(30.0, 80.0), chips=1),
                  sl("s2", 1.0, lpm(60.0, 160.0), chips=1)]
        devs = jax.devices()[:1] if ref else ["cpu"]
        seen = []
        with tempfile.TemporaryDirectory() as d:
            job = (RefJob if ref else ElasticJob)(model, tcfg, d)
            job.start(devs)
            if not ref:
                job.state = from_reference_state(
                    cfg, jax.tree.map(np.asarray, start), "cpu")
            step_flops = 6.0 * model.param_count() * 16 * 4
            trainer = (RefTrainer if ref else CarbonAwareTrainer)(
                job=job, family=fam(slices, baseline_idx=1),
                slice_devices=[devs, devs],
                carbon=(RefTraceProvider if ref else TraceProvider)(trace),
                cfg=(RefCarbonConfig if ref else CarbonConfig)(
                    target_rate=target, interval_s=300.0),
                step_flops=step_flops, step_tokens=64,
                peak_flops_per_chip=step_flops / 120.0,
                sim_seconds_per_step=sim_s)
            data = (RefSyntheticLM if ref else DATA.SyntheticLM)(
                cfg.vocab_size, 16, 4)
            outs.append(trainer.run(iter(data), steps, on_interval=lambda
                                    log, m: seen.append(float(m["loss"]))))
        losses.append(seen)
    ref_out, ours = outs
    assert ours["steps"] == ref_out["steps"] == steps
    assert [dataclasses.asdict(x) for x in ours["logs"]] == [
        dataclasses.asdict(x) for x in ref_out["logs"]]
    assert [m["step"] for m in ours["migrations"]] == [
        m["step"] for m in ref_out["migrations"]]
    assert {"migrate", "suspend", "resume"} <= {x.action for x in ours["logs"]}
    assert len(losses[0]) == len(losses[1]) == steps
    for a, b in zip(losses[1], losses[0]):
        assert abs(a - b) <= 1e-5 * abs(b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains_the_recurrent_families(arch, capsys):
    """`python -m repro_torch.launch.train --arch <arch> --device cpu`
    (smoke config, markov data) trains, as the reference's launcher
    lets it, with remat "full"."""
    argv = ["--arch", arch, "--steps", "3", "--global-batch", "2",
            "--seq-len", "32", "--log-every", "0", "--remat", "full",
            "--device", "cpu"]
    assert train_launch.main(argv) == 0
    assert "final loss" in capsys.readouterr().out
