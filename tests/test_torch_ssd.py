"""The port's Mamba-2 SSD scan and causal conv against the JAX reference
on the CPU: the SSD kernel's wrapper (on CPU tensors, its plain version)
against the Pallas kernel in interpret mode, the chunked and sequential
oracles, the decode step and the conv. Inputs are made with numpy from a
seed and handed to both sides."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_pallas  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402

# tests/test_kernels.py's SSD_CASES: B, S, H, P, N, chunk, bh
SSD_CASES = [
    (2, 64, 4, 16, 32, 16, 2),
    (1, 128, 8, 32, 64, 32, 4),
    (2, 96, 4, 64, 16, 32, 4),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 5e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-1)}


def _inputs(B, S, H, P, N, G=1, seed=0, overflow=False):
    """tests/test_kernels.py's distributions, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    a_log = rng.uniform(0.0, 1.5, H).astype(np.float32)
    if overflow:        # a = -16, dt > 2: |cum| over a chunk is in the 1e4s
        dt, a_log = dt + 2.0, np.full(H, np.log(16.0), np.float32)
    return dict(x=f(B, S, H, P), dt=dt, a_log=a_log, b=f(B, S, G, N),
                c=f(B, S, G, N), d=np.ones(H, np.float32))


def _both(arrs, jdt=jnp.float32, tdt=torch.float32, cast=("x", "b", "c")):
    """The same arrays for JAX and torch; `cast` ones in the given dtype."""
    j = {k: jnp.asarray(v, jdt if k in cast else jnp.float32)
         for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).to(tdt if k in cast else torch.float32)
         for k, v in arrs.items()}
    return j, t


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_scan_matches_pallas_interpret(case, dtype):
    B, S, H, P, N, Q, bh = case
    jdt, tdt, tol = DTYPES[dtype]
    j, t = _both(_inputs(B, S, H, P, N, seed=sum(case)), jdt, tdt)
    jy, jh = ssd_pallas(j["x"], j["dt"], j["a_log"], j["b"], j["c"], j["d"],
                        chunk=Q, block_heads=bh, interpret=True)
    before = ssd_scan.launches
    ty, th = ssd_scan(t["x"], t["dt"], t["a_log"], t["b"], t["c"], t["d"],
                      chunk=Q)
    assert ssd_scan.launches == before          # CPU: the plain version
    assert ty.dtype == tdt and th.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(th), _np(jh), atol=5e-3, rtol=5e-3)


def test_ssd_chunked_with_state_and_groups_matches_reference():
    arrs = _inputs(2, 48, 4, 8, 16, G=2, seed=1)
    arrs["d"] = np.zeros(4, np.float32)
    h0 = np.random.default_rng(2).normal(size=(2, 4, 8, 16)).astype(np.float32)
    j, t = _both(arrs)
    jy, jh = jref.ssd_chunked(**j, h0=jnp.asarray(h0), chunk=16)
    ty, th = ref.ssd_chunked(**t, h0=torch.from_numpy(h0), chunk=16)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(th), _np(jh), atol=2e-3, rtol=2e-3)
    sy, sh = ref.ssd_ref(**t, h0=torch.from_numpy(h0))
    jsy, jsh = jref.ssd_ref(**j, h0=jnp.asarray(h0))
    np.testing.assert_allclose(_np(sy), _np(jsy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(sh), _np(jsh), atol=1e-5, rtol=1e-5)


def test_ssd_masked_triangle_does_not_overflow():
    """exp(cum_q - cum_k) above the diagonal is inf at these inputs; the
    plain version selects it away, as the kernel never forms it."""
    arrs = _inputs(1, 512, 2, 16, 32, seed=3, overflow=True)
    j, t = _both(arrs)
    cum = np.cumsum(arrs["dt"][0, :256, 0] * -16.0)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(np.float32(cum[0] - cum[-1])))
    ty, th = ssd_scan(t["x"], t["dt"], t["a_log"], t["b"], t["c"], t["d"],
                      chunk=256)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(th).all())
    jy, jh = jref.ssd_ref(**j)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(_np(th), _np(jh), atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("h0", [False, True])
def test_ops_ssd_on_the_cpu_runs_the_reference_cpu_path(h0):
    arrs = _inputs(2, 32, 4, 8, 16, seed=5)
    j, t = _both(arrs)
    h = np.random.default_rng(6).normal(size=(2, 4, 8, 16)).astype(np.float32)
    jh0 = jnp.asarray(h) if h0 else None
    th0 = torch.from_numpy(h) if h0 else None
    jy, jhf = jops.ssd(**j, h0=jh0, chunk=16)
    ty, thf = ops.ssd(**t, h0=th0, chunk=16)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(thf), _np(jhf), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown ssd impl"):
        ops.ssd(**t, impl="pallas")


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(7)
    B, H, P, N, G = 3, 4, 8, 16, 2
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    arrs = dict(x=f(B, H, P), dt=np.abs(f(B, H)), a_log=f(H), b=f(B, G, N),
                c=f(B, G, N), d=f(H), h=f(B, H, P, N))
    j, t = _both(arrs)
    jy, jh = jops.ssd_decode_step(**j)
    ty, th = ops.ssd_decode_step(**t)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(th), _np(jh), atol=1e-6, rtol=1e-6)


def test_ssd_decode_steps_continue_the_scan():
    arrs = _inputs(2, 20, 4, 8, 16, seed=8)
    _, t = _both(arrs)
    y, h = ref.ssd_chunked(t["x"][:, :16], t["dt"][:, :16], t["a_log"],
                           t["b"][:, :16], t["c"][:, :16], t["d"], chunk=16)
    y_all, h_all = ref.ssd_ref(**t)
    for s in range(16, 20):
        ys, h = ops.ssd_decode_step(t["x"][:, s], t["dt"][:, s], t["a_log"],
                                    t["b"][:, s], t["c"][:, s], t["d"], h)
        torch.testing.assert_close(ys, y_all[:, s], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, h_all, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("state,bias", [(False, True), (True, False),
                                        (True, True)])
def test_causal_conv1d_matches_reference(state, bias, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(9)
    arrs = dict(x=rng.normal(size=(2, 10, 6)), w=rng.normal(size=(4, 6)),
                b=rng.normal(size=6), state=rng.normal(size=(2, 3, 6)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    j, t = _both(arrs, jdt, tdt, cast=("x", "w", "b", "state"))
    kw = lambda d: dict(b=d["b"] if bias else None,
                        state=d["state"] if state else None)
    jy, js = jops.causal_conv1d(j["x"], j["w"], **kw(j))
    ty, ts = ops.causal_conv1d(t["x"], t["w"], **kw(t))
    assert ty.dtype == tdt and ts.dtype == tdt
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-6, rtol=1e-6)


def test_conv1d_decode_step_matches_reference_and_the_sequence():
    rng = np.random.default_rng(10)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    arrs = dict(x=f(2, 6), w=f(4, 6), b=f(6), state=f(2, 3, 6))
    j, t = _both(arrs)
    jy, js = jops.conv1d_decode_step(j["x"], j["w"], j["b"], j["state"])
    ty, ts = ops.conv1d_decode_step(t["x"], t["w"], t["b"], t["state"])
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-6, rtol=1e-6)
    xs = torch.from_numpy(f(2, 7, 6))
    y_seq, s_seq = ops.causal_conv1d(xs, t["w"], t["b"], t["state"])
    s = t["state"]
    for step in range(7):
        y, s = ops.conv1d_decode_step(xs[:, step], t["w"], t["b"], s)
        torch.testing.assert_close(y, y_seq[:, step], atol=1e-6, rtol=1e-6)
    assert torch.equal(s, s_seq)


def test_ssd_scan_checks_its_inputs():
    _, t = _both(_inputs(1, 32, 2, 16, 8, G=2, seed=11))
    args = [t[k] for k in ("x", "dt", "a_log", "b", "c", "d")]
    with pytest.raises(ValueError, match="one group"):
        ssd_scan(*args, chunk=16)
    _, t = _both(_inputs(1, 30, 2, 16, 8, seed=11))
    with pytest.raises(ValueError, match="not divisible"):
        ssd_scan(*[t[k] for k in ("x", "dt", "a_log", "b", "c", "d")],
                 chunk=16)
