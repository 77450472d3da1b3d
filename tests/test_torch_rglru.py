"""The port's RG-LRU against the JAX reference on the CPU: the kernel's
wrapper and the gated wrapper (on CPU tensors, the plain version)
against the Pallas kernel in interpret mode, the CPU path against
`rglru_assoc`, the sequential oracle and the decode step. Inputs are made
with numpy from a seed and handed to both sides."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_pallas  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan_pallas  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rglru_scan import (rglru_gated,  # noqa: E402
                                            rglru_scan, rglru_scan_torch)

# tests/test_kernels.py's RGLRU_CASES: B, S, W
RGLRU_CASES = [(2, 64, 128), (1, 128, 256), (3, 32, 512)]
# dtype: JAX, torch, y and h tolerances (tests/test_kernels.py's bars)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2, 1e-2)}


def _inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(x=f(B, S, W), r=f(B, S, W), i=f(B, S, W), lam=f(W),
                h0=f(B, W))


def _both(arrs, jdt=jnp.float32, tdt=torch.float32, cast=("x", "r", "i")):
    j = {k: jnp.asarray(v, jdt if k in cast else jnp.float32)
         for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).to(tdt if k in cast else torch.float32)
         for k, v in arrs.items()}
    return j, t


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
def test_gated_scan_matches_pallas_interpret(case, dtype):
    jdt, tdt, tol, htol = DTYPES[dtype]
    j, t = _both(_inputs(*case, seed=sum(case)), jdt, tdt)
    jy, jh = rglru_pallas(j["x"], j["r"], j["i"], j["lam"], interpret=True)
    before = rglru_scan.launches
    ty, th = rglru_gated(t["x"], t["r"], t["i"], t["lam"])
    assert rglru_scan.launches == before        # CPU: the plain version
    assert ty.dtype == tdt and th.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(th), _np(jh), atol=htol, rtol=htol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_raw_scan_with_state_matches_pallas_interpret(dtype):
    """`rglru_scan` on the same (a in the input dtype, gx, h0) as the
    Pallas kernel: the kernel's own contract, h0 included."""
    jdt, tdt, tol, htol = DTYPES[dtype]
    arrs = _inputs(2, 64, 128, seed=3)
    _, t = _both(arrs)
    a, gx = ref.rglru_gates(t["x"], t["r"], t["i"], t["lam"])
    a = a.to(tdt)
    jy, jh = rglru_scan_pallas(jnp.asarray(_np(a), jdt), jnp.asarray(_np(gx)),
                               jnp.asarray(arrs["h0"]), interpret=True)
    ty, th = rglru_scan(a, gx, t["h0"])
    assert ty.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(th), _np(jh), atol=htol, rtol=htol)
    torch.testing.assert_close(rglru_scan_torch(a, gx, t["h0"])[0], ty)


def test_cpu_path_matches_rglru_assoc_with_state():
    j, t = _both(_inputs(2, 40, 32, seed=4))
    jy, jh = jref.rglru_assoc(j["x"], j["r"], j["i"], j["lam"], h0=j["h0"])
    ty, th = ops.rglru(t["x"], t["r"], t["i"], t["lam"], h0=t["h0"])
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(th), _np(jh), atol=1e-5, rtol=1e-5)
    ay, ah = ref.rglru_assoc(t["x"], t["r"], t["i"], t["lam"])
    jay, jah = jref.rglru_assoc(j["x"], j["r"], j["i"], j["lam"])
    np.testing.assert_allclose(_np(ay), _np(jay), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(ah), _np(jah), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown rglru impl"):
        ops.rglru(t["x"], t["r"], t["i"], t["lam"], impl="pallas")


@pytest.mark.parametrize("h0", [False, True])
def test_sequential_oracle_matches_reference(h0):
    j, t = _both(_inputs(2, 33, 16, seed=5))
    jy, jh = jref.rglru_ref(j["x"], j["r"], j["i"], j["lam"],
                            h0=j["h0"] if h0 else None)
    ty, th = ref.rglru_ref(t["x"], t["r"], t["i"], t["lam"],
                           h0=t["h0"] if h0 else None)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(th), _np(jh), atol=1e-6, rtol=1e-6)
    ay, ah = ref.rglru_assoc(t["x"], t["r"], t["i"], t["lam"],
                             h0=t["h0"] if h0 else None)
    torch.testing.assert_close(ay, ty, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ah, th, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_step_matches_reference(dtype):
    jdt, tdt = DTYPES[dtype][:2]
    arrs = {k: v[:, 0] if v.ndim == 3 else v
            for k, v in _inputs(3, 1, 24, seed=6).items()}
    j, t = _both(arrs, jdt, tdt)
    jy, jh = jops.rglru_decode_step(j["x"], j["r"], j["i"], j["lam"],
                                    j["h0"])
    ty, th = ops.rglru_decode_step(t["x"], t["r"], t["i"], t["lam"], t["h0"])
    assert ty.dtype == tdt and th.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(th), _np(jh), atol=1e-6, rtol=1e-6)


def test_decode_steps_continue_the_scan():
    _, t = _both(_inputs(2, 12, 16, seed=7))
    y_all, h_all = ref.rglru_ref(t["x"], t["r"], t["i"], t["lam"])
    _, h = ref.rglru_ref(t["x"][:, :8], t["r"][:, :8], t["i"][:, :8],
                         t["lam"])
    for s in range(8, 12):
        y, h = ops.rglru_decode_step(t["x"][:, s], t["r"][:, s],
                                     t["i"][:, s], t["lam"], h)
        torch.testing.assert_close(y, y_all[:, s], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(h, h_all, atol=1e-6, rtol=1e-6)


def test_softplus_is_jax_softplus_past_the_torch_threshold():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.5, 20.5, 25.0, 80.0], np.float32)
    got = ref.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.softplus(x)))


def test_rglru_scan_checks_its_inputs():
    a = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="float32"):
        rglru_scan(a, a.to(torch.bfloat16), torch.zeros(2, 8))
    with pytest.raises(ValueError, match="h0 must be"):
        rglru_scan(a, a, torch.zeros(2, 4))
