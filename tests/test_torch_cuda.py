"""Tests that need the card: the CUDA admission, flash-attention, SSD and
RG-LRU kernels against their plain versions (the tensor-core routes at
the edges of their tiles too), card-vs-CPU plan equality
and card-vs-CPU serving (SmolLM, Mamba-2, RecurrentGemma). They skip without a GPU. On the
card, where JAX (which ``tests/conftest.py`` imports) is not installed:
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernel, no CPU mode)")
    return torch.device("cuda", 0)


# 400,000 and 600,000 need more 1,024-container tiles than the card holds
# blocks at once (an H100 holds 132), so each block walks several: up to 4
# with their state in registers, more with it in global memory
@pytest.mark.parametrize("N,R", [(1, 2), (1023, 3), (1025, 3), (12_345, 5),
                                 (100_000, 31), (400_000, 3), (600_000, 3)])
def test_admission_kernel_equals_plain_version(cuda, N, R):
    from repro_torch.cluster.placement_kernel import (admission_round,
                                                      admission_round_torch,
                                                      admission_rounds,
                                                      admission_rounds_torch)
    rng = np.random.default_rng(N + R)
    i32 = dict(dtype=torch.int32, device=cuda)
    args = (torch.as_tensor(np.round(rng.normal(size=(N, R)) * 4) / 4,
                            dtype=torch.float64, device=cuda),
            torch.as_tensor(rng.integers(0, R, N), **i32),
            torch.as_tensor(rng.random(N) < 0.8, device=cuda),
            torch.as_tensor(np.where(rng.random(N) < 0.2,
                                     rng.integers(0, R, N), -1), **i32),
            torch.as_tensor(rng.integers(0, 1 << min(R, 30), N), **i32),
            torch.as_tensor(rng.integers(0, max(2, N // (4 * R)), R), **i32))
    before = admission_rounds.launches
    got = admission_round(*args)
    assert admission_rounds.launches == before + 1
    want = admission_round_torch(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = admission_rounds(*args, R)
    assert admission_rounds.launches == before + 2
    want = admission_rounds_torch(*args, R)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_plan_on_card_equals_cpu(cuda):
    from repro_torch.carbon.intensity import TraceProvider
    from repro_torch.cluster.placement import (PlacementConfig,
                                               PlacementEngine, plan_torch)
    from repro_torch.cluster.slices import paper_family
    from repro_torch.workload.azure_like import sample_population_matrix
    n = 700
    demand = sample_population_matrix(n, days=1, seed=2)
    eng = PlacementEngine(
        paper_family(), [TraceProvider.for_region(r, hours=24, seed=1)
                         for r in ("PL", "NL", "CAISO")],
        config=PlacementConfig(capacity=int(0.6 * n), min_dwell=6))
    a = plan_torch(eng, demand, device=cuda)
    b = plan_torch(eng, demand, device="cpu")
    assert np.array_equal(a.assign, b.assign)
    assert np.array_equal(a.migrations, b.migrations)
    assert np.allclose(a.overhead_g, b.overhead_g, rtol=1e-12, atol=0.0)


# B, Sq, Skv, Hq, Hkv, Dh, causal, window: tests/test_kernels.py's
# ATTN_CASES, the serving shapes (phi4-mini, smollm), the other head
# sizes, a ragged tail and Sq < Skv
FLASH_CASES = [
    (2, 128, 128, 4, 2, 32, True, 0), (1, 64, 64, 2, 1, 16, True, 24),
    (2, 128, 128, 4, 4, 64, False, 0), (1, 96, 96, 8, 2, 32, True, 0),
    (4, 2048, 2048, 24, 8, 128, True, 0), (2, 512, 512, 9, 3, 64, True, 0),
    (1, 200, 200, 2, 1, 256, True, 70), (2, 77, 77, 6, 2, 128, False, 0),
    (1, 40, 130, 4, 2, 64, False, 0), (1, 40, 130, 4, 2, 64, False, 50),
    # RecurrentGemma: Dh 256, 16:1 heads, a window that bites
    (1, 1024, 1024, 16, 1, 256, True, 512),
    (1, 2048, 2048, 16, 1, 256, True, 2048),
    # across the wgmma kernel's 64-key tiles and 128-row blocks: Sq, Skv
    # not multiples of 64; Sq != Skv; a window that ends inside a tile;
    # G = 3 and G = 16; Dh 64, 128 and 256
    (2, 200, 200, 6, 2, 64, True, 0), (1, 1000, 1000, 16, 1, 128, True, 0),
    (1, 1024, 1024, 4, 4, 256, True, 300), (1, 200, 1000, 6, 2, 128, False, 0),
    (1, 1000, 200, 3, 1, 64, True, 0), (2, 1000, 1000, 8, 8, 256, False, 300),
    (1, 77, 77, 16, 1, 128, True, 5), (2, 1000, 1000, 48, 16, 64, True, 300),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_equals_plain_version(cuda, case, dtype):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch,
                                                     route)
    B, Sq, Skv, Hq, Hkv, Dh, causal, window = case
    dt = getattr(torch, dtype)
    path = route(dt, Dh)
    assert path == ("wgmma" if dtype == "bfloat16" and Dh >= 64
                    else "cuda_core")
    gen = torch.Generator(device=cuda).manual_seed(sum(case[:6]))
    q = torch.randn(B, Sq, Hq, Dh, generator=gen, device=cuda).to(dt)
    k = torch.randn(B, Skv, Hkv, Dh, generator=gen, device=cuda).to(dt)
    v = torch.randn(B, Skv, Hkv, Dh, generator=gen, device=cuda).to(dt)
    before = flash_attention.launches
    on_route = flash_attention.route_launches[path]
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_torch(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.route_launches[path] == on_route + 1
    assert got.dtype == dt and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_serving_on_card_equals_cpu(cuda):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.api import get_model
    from repro_torch.models.params import tree_map
    cfg = dataclasses.replace(get_arch("smollm-135m").smoke, dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    tokens = {"tokens": torch.as_tensor(prompts)}
    on_card = {k: v.to(cuda) for k, v in tokens.items()}
    card_params = tree_map(lambda t: t.to(cuda), params)
    before = flash_attention.launches
    a, ca = model.prefill(card_params, on_card, pad_to=44)
    b, cb = model.prefill(params, tokens, pad_to=44)
    assert flash_attention.launches == before + cfg.n_layers
    torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    for _ in range(3):
        tok = torch.argmax(b, -1)
        a, ca = model.decode(card_params, ca, tok.to(cuda))
        b, cb = model.decode(params, cb, tok)
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


# B, S, H, P, N, chunk: tests/test_kernels.py's SSD_CASES, Mamba-2's smoke
# shape, the serving shape at batch 1, then the tile edges of the bf16
# route: chunks of 64 and 256 with N 128, P 16, H not a multiple of the
# output launch's head group
SSD_CASES = [(2, 64, 4, 16, 32, 16), (1, 128, 8, 32, 64, 32),
             (2, 96, 4, 64, 16, 32), (2, 48, 4, 32, 16, 16),
             (1, 512, 80, 64, 128, 256),
             (2, 512, 8, 64, 128, 64), (1, 1024, 12, 64, 128, 256),
             (2, 256, 8, 16, 64, 64), (1, 256, 5, 32, 128, 128)]


def _ssd_inputs(case, dtype, dev, seed, overflow=False):
    """tests/test_kernels.py's distributions; `overflow`: |a|·dt large
    enough that exp(cum_q - cum_k) above the diagonal is inf."""
    B, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape),
                                       dtype=torch.float32, device=dev)
    dt = torch.nn.functional.softplus(f(B, S, H))
    a_log = torch.as_tensor(rng.uniform(0.0, 1.5, H), dtype=torch.float32,
                            device=dev)
    if overflow:
        dt, a_log = dt + 2.0, torch.full_like(a_log, float(np.log(16.0)))
    return (f(B, S, H, P).to(dtype), dt, a_log, f(B, S, 1, N).to(dtype),
            f(B, S, 1, N).to(dtype), torch.ones(H, device=dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_kernel_equals_plain_version(cuda, case, dtype):
    from repro_torch.kernels.ssd_scan import ROUTES, ssd_scan, ssd_scan_torch
    dt = getattr(torch, dtype)
    path = ROUTES[dt]
    assert path == ("mma_sync" if dtype == "bfloat16" else "cuda_core")
    args = _ssd_inputs(case, dt, cuda, seed=sum(case))
    before = ssd_scan.launches
    on_route = ssd_scan.route_launches[path]
    y, h = ssd_scan(*args, chunk=case[5])
    y_want, h_want = ssd_scan_torch(*args, chunk=case[5])
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert ssd_scan.route_launches[path] == on_route + 1
    assert y.dtype == dt and h.dtype == torch.float32
    tol = 5e-3 if dtype == "float32" else 1e-1
    torch.testing.assert_close(y.float(), y_want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_want, atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_reads_the_mixers_strided_views(cuda, dtype):
    """x, b and c as `_mixer_seq` passes them: slices of one (B, S, di +
    2N) conv output, uncopied."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_torch
    B, S, H, P, N, Q = 2, 512, 8, 64, 128, 256
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    xc = torch.as_tensor(rng.normal(size=(B, S, H * P + 2 * N)),
                         dtype=torch.float32, device=cuda).to(dt)
    xs, b, c = torch.split(xc, [H * P, N, N], dim=-1)
    x, b, c = xs.reshape(B, S, H, P), b.reshape(B, S, 1, N), c.reshape(
        B, S, 1, N)
    assert not (x.is_contiguous() or b.is_contiguous())
    dts = torch.nn.functional.softplus(torch.as_tensor(
        rng.normal(size=(B, S, H)), dtype=torch.float32, device=cuda))
    a_log = torch.as_tensor(rng.uniform(0.0, 1.5, H), dtype=torch.float32,
                            device=cuda)
    d = torch.ones(H, device=cuda)
    y, h = ssd_scan(x, dts, a_log, b, c, d, chunk=Q)
    y_want, h_want = ssd_scan_torch(x.contiguous(), dts, a_log,
                                    b.contiguous(), c.contiguous(), d,
                                    chunk=Q)
    torch.cuda.synchronize()
    tol = 5e-3 if dtype == "float32" else 1e-1
    torch.testing.assert_close(y.float(), y_want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_want, atol=5e-3, rtol=5e-3)


def test_ssd_kernel_does_not_overflow_above_the_diagonal(cuda):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_torch
    case = (2, 512, 4, 64, 128, 256)
    args = _ssd_inputs(case, torch.float32, cuda, seed=3, overflow=True)
    y, h = ssd_scan(*args, chunk=256)
    y_want, h_want = ssd_scan_torch(*args, chunk=256)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, y_want, atol=5e-3, rtol=5e-3)
    torch.testing.assert_close(h, h_want, atol=5e-3, rtol=5e-3)


# B, S, W: tests/test_kernels.py's RGLRU_CASES, a ragged tail (W 100:
# the column route), ragged tiles of the ring route (S 100 and W 136 not
# multiples of 64), the serving shape at batch 1
RGLRU_CASES = [(2, 64, 128), (1, 128, 256), (3, 32, 512), (2, 37, 100),
               (2, 100, 136), (1, 2048, 4096)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
def test_rglru_kernel_equals_plain_version(cuda, case, dtype):
    """Bit-equal to the plain version on the ring route; within the
    kernel tests' bars on the column route."""
    from repro_torch.kernels.rglru_scan import (rglru_gated, rglru_scan,
                                                rglru_scan_torch, route)
    from repro_torch.kernels.ref import rglru_gates
    B, S, W = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(case))
    x, r, i = (torch.as_tensor(rng.normal(size=(B, S, W)), dtype=torch.float32,
                               device=cuda).to(dt) for _ in range(3))
    lam = torch.as_tensor(rng.normal(size=W), dtype=torch.float32, device=cuda)
    h0 = torch.as_tensor(rng.normal(size=(B, W)), dtype=torch.float32,
                         device=cuda)
    a, gx = rglru_gates(x, r, i, lam)
    a = a.to(dt)
    path = route(a, gx)
    assert path == ("column" if W % 8 else "ring")
    before = rglru_scan.launches
    routes = dict(rglru_scan.route_launches)
    y, h = rglru_scan(a, gx, h0)
    y_want, h_want = rglru_scan_torch(a, gx, h0)
    yg, hg = rglru_gated(x, r, i, lam, h0=h0)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 2
    assert rglru_scan.route_launches[path] == routes[path] + 2
    assert y.dtype == torch.float32 and yg.dtype == dt
    if path == "ring":
        assert torch.equal(y, y_want) and torch.equal(h, h_want)
        assert torch.equal(yg, y_want.to(dt)) and torch.equal(hg, h_want)
        return
    tol, htol = (1e-5, 1e-4) if dtype == "float32" else (3e-2, 1e-2)
    torch.testing.assert_close(y, y_want, atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_want, atol=htol, rtol=htol)
    torch.testing.assert_close(yg.float(), y_want.to(dt).float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(hg, h_want, atol=htol, rtol=htol)


@pytest.mark.parametrize("arch,n_layers,kernel,per_prefill", [
    ("mamba2-2.7b", 2, "ssd", 2), ("recurrentgemma-9b", 4, "rglru", 3)])
def test_recurrent_serving_on_card_equals_cpu(cuda, arch, n_layers, kernel,
                                             per_prefill):
    """Full widths at reduced depth in float32; RecurrentGemma with one
    superlayer and one trailing block, a window of 128 that bites in the
    prefill and wraps in decode."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.api import get_model
    from repro_torch.models.params import tree_map
    cfg = dataclasses.replace(get_arch(arch).full, n_layers=n_layers,
                              dtype="float32", local_window=128)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    card_params = tree_map(lambda t: t.to(cuda), params)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256)))
    counter = {"ssd": ssd_scan, "rglru": rglru_scan}[kernel]
    before = counter.launches
    a, ca = model.prefill(card_params, {"tokens": prompts.to(cuda)})
    b, cb = model.prefill(params, {"tokens": prompts})
    assert counter.launches == before + per_prefill
    torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=1e-3)
    for _ in range(8):
        tok = torch.argmax(b, -1)
        a, ca = model.decode(card_params, ca, tok.to(cuda))
        b, cb = model.decode(params, cb, tok)
        torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=1e-3)
