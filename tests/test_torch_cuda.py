"""Tests that need the card: the CUDA admission, flash-attention, SSD and
RG-LRU kernels against their plain versions (the tensor-core routes at
the edges of their tiles too), card-vs-CPU plan equality, the layered
sweep card against CPU (`devmath`, the traffic, energy and
elasticity steps, the faulted plan, the rows with all four layers and
with traffic and energy folded into the scan), the scenario matrix and a
custom policy's host decisions card against CPU, card-vs-CPU serving
(SmolLM, Mamba-2, RecurrentGemma, OLMoE's routing, Whisper), and
training: the flash kernel's log-sum-exp and gradients through
`FlashAttentionFn` (the bf16 backward kernel at every mask it serves),
the SSD and RG-LRU kernels under autograd (`SSDScanFn`, `RGLRUScanFn`
with its reverse scan on the ring route),
the raw wrappers' refusal to cut the autograd graph, and a train step
card against CPU for each family. They skip without a GPU. On the
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


@pytest.mark.parametrize("L", [3, 1024, 1025, 8_000, 400_000])
def test_devmath_on_card_equals_cpu(cuda, L):
    """Bit-equal on both devices: quotients by constants, prefix sums and
    sums in the fixed order."""
    from repro_torch.devmath import divide, ordered_cumsum, ordered_sum
    rng = np.random.default_rng(L)
    x = torch.as_tensor(rng.random((L, 3)) * rng.choice([1e-3, 1.0, 1e4],
                                                         (L, 3)))
    assert torch.equal(ordered_cumsum(x[:, 0].to(cuda)).cpu(),
                       ordered_cumsum(x[:, 0]))
    assert torch.equal(ordered_sum(x.to(cuda)).cpu(), ordered_sum(x))
    for c in (3600.0, 1000.0, 0.3, 7.0):
        assert torch.equal(divide(x.to(cuda), c).cpu(), x / c)


@pytest.mark.parametrize("L", [8_000, 400_000])
def test_budget_cut_on_card_is_numpys(cuda, L):
    """The greedies' budget cut past one fixed-order block: a budget
    between the block order's prefix sum and NumPy's left fold is decided
    as ``np.cumsum`` decides it, on the card as on the CPU."""
    from repro_torch import devmath
    from repro_torch.devmath import budget_admits, ordered_cumsum, ordered_sum
    rng = np.random.default_rng(L)
    mand = np.where(rng.random(L) < 0.3, rng.random(L), 0.0)
    gs = rng.random(L) * rng.choice([1e-3, 1.0, 1e2], L)
    seq = np.cumsum(mand)[-1] + np.cumsum(gs)
    m_t, g_t = torch.as_tensor(mand), torch.as_tensor(gs)
    blk = (ordered_sum(m_t) + ordered_cumsum(g_t)).numpy()
    split = np.flatnonzero(seq != blk)
    k = split[len(split) // 3]
    budget = min(seq[k], blk[k])
    live = rng.random(L) < 0.9
    live[k] = True
    live = torch.as_tensor(live)
    before = devmath.refolds
    got = budget_admits(m_t.to(cuda), g_t.to(cuda), budget, live.to(cuda))
    assert devmath.refolds == before + 1
    assert torch.equal(got.cpu(), budget_admits(m_t, g_t, budget, live))
    assert np.array_equal(got.cpu().numpy(), live.numpy() & (seq <= budget))


def test_layer_steps_on_card_equal_cpu(cuda):
    """The faulted plan, the traffic replicas under a budget, the supply
    ledger and the elastic levels: counts equal, floats within 1e-12."""
    import dataclasses

    from repro_torch.cluster.placement import plan_torch
    from repro_torch.core.elasticity_torch import simulate_elastic_torch
    from repro_torch.energy.supply import EnergyConfig, EnergySpec
    from repro_torch.energy.supply_torch import simulate_supply_torch
    from repro_torch.launch.sweep_scale import engine, layers
    from repro_torch.traffic import request_matrix
    from repro_torch.traffic.sim_torch import simulate_traffic_torch
    from repro_torch.workload.azure_like import sample_population_matrix
    n = 500
    demand = sample_population_matrix(n, days=1, seed=2)
    _, eng = engine(n)
    lay = layers(n)
    pa, pb = (plan_torch(eng, demand, faults=lay["faults"], device=d)
              for d in (cuda, "cpu"))
    for f in ("assign", "migrations", "failed_migrations"):
        assert np.array_equal(getattr(pa, f), getattr(pb, f)), f
    cfg = dataclasses.replace(lay["traffic"], replicas=dataclasses.replace(
        lay["traffic"].replicas, budget_g_per_epoch=16.0))
    req = request_matrix(cfg.population, 288, 300.0).requests
    a, b = (simulate_traffic_torch(req, pb.region_intensity, cfg, device=d)
            for d in (cuda, "cpu"))
    assert np.array_equal(a.replicas, b.replicas)
    assert np.allclose(a.served, b.served, rtol=1e-12, atol=0.0)
    rng = np.random.default_rng(0)
    streams = (rng.uniform(0.0, 4000.0, (288, 3)),
               rng.uniform(0.0, 3000.0, (288, 3)),
               rng.uniform(20.0, 600.0, (288, 3)),
               (rng.random((288, 3)) > 0.1).astype(float))
    spec = EnergySpec.from_config(EnergyConfig(), 50, 3, 300.0, 2.0)
    a, b = (simulate_supply_torch(*streams, spec, device=d)
            for d in (cuda, "cpu"))
    for f in ("soc", "supplied", "cap_frac", "c_eff"):
        assert np.allclose(getattr(a, f), getattr(b, f), rtol=1e-12,
                           atol=0.0), f
    ela = dataclasses.replace(lay["elasticity"], budget_g_per_epoch=4.0 * n)
    plan = plan_torch(eng, demand, device="cpu")
    a, b = (simulate_elastic_torch(demand, (plan.region_intensity,
                                            plan.assign), ela, 300.0,
                                   record=True, device=d)
            for d in (cuda, "cpu"))
    assert np.array_equal(a.levels, b.levels)
    assert a.levels.sum() > n * 288            # optional levels admitted


@pytest.mark.parametrize("elasticity", [True, False],
                         ids=["all_four", "folded_in_scan"])
def test_layered_sweep_on_card_equals_cpu(cuda, elasticity):
    """jax_sweep_scale's layers and fault plan at 400 traces x 10
    targets: rows within 1e-6, counts exact."""
    from repro_torch.launch.sweep_scale import engine, spec
    from repro_torch.workload.azure_like import sample_population_matrix
    n = 400
    demand = sample_population_matrix(n, days=1, seed=2)
    _, eng = engine(n)
    a, b = (spec(demand, eng, d, elasticity=elasticity).run()
            for d in (cuda, "cpu"))
    assert [set(r) for r in a] == [set(r) for r in b]
    assert a.parity(b) <= 1e-6
    for x, y in zip(a, b):
        for k in ("migrations_mean", "placement_migrations_mean",
                  "fault_failed_migrations_mean", "elastic_level_epochs",
                  "traffic_replica_epochs", "energy_cap_violations",
                  "energy_soc_violations", "elastic_cap_violations"):
            if k in x:
                assert x[k] == y[k], k


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
    # the MoE and encoder-decoder prefills: Whisper-base's encoder (1,500
    # frames, non-causal: a ragged last key tile) and cross-attention (4
    # decoder rows against 1,500 keys), OLMoE's 16:16 and DBRX's 48:8
    (8, 1500, 1500, 8, 8, 64, False, 0), (8, 4, 1500, 8, 8, 64, False, 0),
    (4, 2048, 2048, 16, 16, 128, True, 0), (4, 2048, 2048, 48, 8, 128, True, 0),
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


def _card_vs_cpu(cuda, model, batch, steps=8, tol=1e-3):
    """Prefill and `steps` decode steps of the same float32 weights on
    the card and on the CPU, the decode fed the CPU's greedy tokens;
    every step's logits within `tol`. Returns the card's prefill flash
    launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.params import tree_map
    params = model.init(0, device="cpu")
    card_params = tree_map(lambda t: t.to(cuda), params)
    before = flash_attention.launches
    a, ca = model.prefill(card_params, {k: v.to(cuda) for k, v in
                                        batch.items()}, pad_to=64)
    launches = flash_attention.launches - before
    b, cb = model.prefill(params, batch, pad_to=64)
    torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=tol)
    for _ in range(steps):
        tok = torch.argmax(b, -1)
        a, ca = model.decode(card_params, ca, tok.to(cuda))
        b, cb = model.decode(params, cb, tok)
        torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=tol)
    return launches


def test_moe_serving_on_card_equals_cpu(cuda, monkeypatch):
    """OLMoE's routing (64 experts, top 8, capacity factor 1.25) at a
    narrow width with its heads of 128, 2 layers, in float32: the logits
    within 1e-3 and the routing ids equal."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.models.api import get_model
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b").full, n_layers=2,
                              d_model=512, n_heads=4, n_kv_heads=4, d_ff=256,
                              vocab_size=1024, dtype="float32")
    routes = {"cuda": [], "cpu": []}
    route = moe._route

    def recorded(cfg, router, x_flat):
        out = route(cfg, router, x_flat)
        routes[x_flat.device.type].append(out[1].cpu())
        return out
    monkeypatch.setattr(moe, "_route", recorded)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)))
    assert _card_vs_cpu(cuda, get_model(cfg), {"tokens": prompts}) == 2
    assert len(routes["cuda"]) == len(routes["cpu"]) == 2 * 9
    for a, b in zip(routes["cuda"], routes["cpu"]):
        assert torch.equal(a, b)


def test_encdec_serving_on_card_equals_cpu(cuda):
    """Whisper-base's widths (8 heads of 64, 1,500 frames) at 2 encoder
    and 2 decoder layers in float32: 6 flash launches a prefill (encoder
    self-attention, decoder self- and cross-attention)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.api import get_model
    cfg = dataclasses.replace(get_arch("whisper-base").full, n_layers=2,
                              n_enc_layers=2, dtype="float32")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (2, 4))),
             "frames": torch.as_tensor(rng.normal(
                 size=(2, cfg.enc_seq, cfg.d_model)), dtype=torch.float32)}
    assert _card_vs_cpu(cuda, get_model(cfg), batch) == 6


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


SCENARIOS = ("baseline", "fleet_churn", "grid_outage", "intensity_shock",
             "migration_failures", "stragglers", "demand_burst",
             "telemetry_blackout", "flapping_feed", "migration_storm")


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_on_card_equals_cpu(cuda, name):
    """Each cell of the scenario matrix at T = 64, 8 traces: the energy
    step folded into the fleet scan on the card, held against the CPU;
    the invariants hold and the rows are the CPU's bit for bit."""
    from repro_torch.cluster.placement_kernel import admission_rounds
    from repro_torch.energy import scenarios as sc
    cell = next(s for s in sc.build_matrix(64) if s.name == name)
    before = admission_rounds.launches
    out = sc.run_scenario(cell, T=64, n_tr=8, targets=(40.0,),
                          devices=("cuda", "cpu"))
    assert admission_rounds.launches == before + 64
    assert out["ok"], out["checks"]
    assert out["checks"]["backend_parity"] == 0.0
    for a, b in zip(out["results"]["cuda"], out["results"]["cpu"]):
        assert a == b


@pytest.mark.parametrize("base", ["agnostic", "cc"])
def test_custom_policy_on_card_equals_cpu(cuda, base):
    """A subclassed stock policy runs its own `decide_batch` on the host
    once an epoch: the same rows on the card as on the CPU, and as the
    stock kernel's on the card."""
    from repro_torch.cluster.slices import paper_family
    from repro_torch.core import policy
    from repro_torch.core.spec import SweepSpec
    from repro_torch.launch.sweep_scale import engine
    from repro_torch.workload.azure_like import sample_population_matrix
    stock = {"agnostic": policy.CarbonAgnosticPolicy,
             "cc": policy.CarbonContainerPolicy}[base]

    class Custom(stock):
        pass
    demand = sample_population_matrix(200, days=1, seed=1)
    _, eng = engine(200)

    def run(pol, device):
        return SweepSpec(policies={"x": pol}, family=paper_family(),
                         traces=demand, targets=[30.0, 60.0], placement=eng,
                         device=device).run()
    card = run(Custom, cuda)
    assert card.rows == run(Custom, "cpu").rows
    assert card.parity(run(stock, cuda)) <= 1e-9


# B, S, Hq, Hkv, Dh, causal, window: tests/test_kernels.py's self-attention
# cases, a padded kv block at the reference's 512 / 1,024 blocking (S
# 1,100), a window, and SmolLM-135M's heads (9:3 of 64)
TRAIN_FLASH_CASES = [(2, 128, 4, 2, 32, True, 0), (1, 64, 2, 1, 16, True, 24),
                     (2, 128, 4, 4, 64, False, 0), (1, 96, 8, 2, 32, True, 0),
                     (1, 1100, 9, 3, 64, True, 0), (1, 700, 4, 1, 128, True, 200),
                     (2, 512, 9, 3, 64, True, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TRAIN_FLASH_CASES, ids=str)
def test_flash_fn_lse_and_grads_on_card(cuda, case, dtype):
    """`FlashAttentionFn` on the card: one launch on the kernel's "+lse"
    route; the log-sum-exp against the plain version's
    (`ref.flash_fwd_torch`) within 1e-5 (float32) / 1e-4 (bf16: the
    tensor cores' products summed in another order and __expf) absolute;
    out within the flash bars (2e-5 / 2e-2); dq, dk, dv against autograd
    through `attention_ref` on the same inputs within 1e-4 / 2e-2 of
    each one's max |g|. The backward goes through the kernel (one call
    of `flash_attention_backward`'s kernel) exactly where
    `BACKWARD_KERNEL` says: bf16 at Dh 64 and 128; never for float32."""
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn, backward_route, flash_attention,
        flash_attention_backward, route)
    from repro_torch.kernels.ref import attention_ref, flash_fwd_torch
    B, S, Hq, Hkv, Dh, causal, window = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(sum(case[:5]))
    q, k, v = (torch.randn(B, S, h, Dh, generator=gen, device=cuda).to(dt)
               for h in (Hq, Hkv, Hkv))
    dout = torch.randn(B, S, Hq, Dh, generator=gen, device=cuda).to(dt)
    path = route(dt, Dh) + "+lse"
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        want_out, want_lse = flash_fwd_torch(q, k, v, causal, window)
    torch.testing.assert_close(lse, want_lse, atol=1e-5 if dtype == "float32"
                               else 1e-4, rtol=0)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol,
                               rtol=tol)
    before = flash_attention.route_launches[path]
    bwd_before = flash_attention_backward.launches
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got_out = FlashAttentionFn.apply(*leaves, causal, window, None)
    got = torch.autograd.grad(got_out, leaves, dout)
    assert flash_attention.route_launches[path] == before + 1
    kernel = dtype == "bfloat16" and Dh in (64, 128)
    assert backward_route(dt, Dh) == ("wgmma" if kernel else "plain")
    assert flash_attention_backward.launches == bwd_before + kernel
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref_leaves, causal=causal,
                                             window=window), ref_leaves, dout)
    gtol = 1e-4 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= gtol * scale


# B, Sq, Skv, Hq, Hkv, Dh, causal, window: each mask the backward kernel
# serves in bf16: Dh 128 with a window; Whisper's cross-attention (non-
# causal, Sq != Skv, a ragged last tile of 1,500 keys) at a decode prompt
# and at the decoder's 448 rows; causal with Sq > Skv and Sq < Skv; S =
# 1,100 (partial q and key tiles); GQA 16:1; SmolLM-135M's microbatches
# of 8 x 4,096 and of 64 x 512
FLASH_BWD_CASES = [(1, 700, 700, 4, 1, 128, True, 200),
                   (8, 4, 1500, 8, 8, 64, False, 0),
                   (2, 448, 1500, 8, 8, 64, False, 0),
                   (1, 1000, 200, 3, 1, 64, True, 0),
                   (2, 200, 1000, 6, 2, 128, True, 0),
                   (1, 1100, 1100, 9, 3, 64, True, 0),
                   (1, 1000, 1000, 16, 1, 128, True, 0),
                   (2, 1000, 1000, 8, 2, 64, False, 300),
                   (8, 4096, 4096, 9, 3, 64, True, 0),
                   (64, 512, 512, 9, 3, 64, True, 0)]


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
def test_flash_backward_kernel_on_card(cuda, case):
    """`FlashAttentionFn` in bf16 through the backward kernel (one call a
    backward): dq, dk, dv within 2e-2 of each one's max |g| of autograd
    through `attention_ref` on the same inputs (float32), and within
    1.5e-2 of the plain backward `ref.flash_bwd_torch` on the same
    (q, k, v, out, lse, dout): both round their outputs to bf16 (2^-9 of
    |g| each) and the kernel rounds P and dS to bf16 before their
    products (≈ 2^-9 a term). Two more calls of the kernel on the same
    inputs give the same bits as the first (dq sums the key blocks in a
    fixed order)."""
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn, flash_attention, flash_attention_backward)
    from repro_torch.kernels.ref import attention_ref, flash_bwd_torch
    B, Sq, Skv, Hq, Hkv, Dh, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(sum(case[:6]))
    q, k, v, dout = (torch.randn(B, s, h, Dh, generator=gen, device=cuda)
                     .to(torch.bfloat16)
                     for s, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv), (Sq, Hq)))
    before = flash_attention_backward.launches
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(FlashAttentionFn.apply(
        *leaves, causal, window, None), leaves, dout)
    assert flash_attention_backward.launches == before + 1
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    plain = flash_bwd_torch(q, k, v, out, lse, dout, causal, window,
                            Dh ** -0.5)
    for _ in range(2):
        again = flash_attention_backward(q, k, v, out, lse, dout,
                                         causal=causal, window=window)
        assert all(torch.equal(a, g) for a, g in zip(again, got))
    del out, lse, again
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(
        *ref_leaves, causal=causal, window=window), ref_leaves, dout.float())
    for g, w, p in zip(got, want, plain):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert not torch.isnan(g).any()
        scale = float(w.abs().max())
        assert float((g.float() - w).abs().max()) <= 2e-2 * scale
        scale = float(p.float().abs().max())
        assert float((g.float() - p.float()).abs().max()) <= 1.5e-2 * scale


def test_mha_trains_through_the_flash_kernel(cuda):
    """Before the kernel wrappers refused grad, `ops.mha` on the card
    returned the kernel's output cut from the graph: q.grad stayed None
    and the q/k/v side of attention did not train. Now the gradient
    reaches q, k and v through `FlashAttentionFn` and equals autograd
    through `attention_ref` (float32, 1e-4 of max |g|)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 64, h, 32, generator=gen, device=cuda)
               .requires_grad_() for h in (4, 2, 2))
    before = flash_attention.route_launches["cuda_core+lse"]
    ops.mha(q, k, v, causal=True).square().sum().backward()
    assert flash_attention.route_launches["cuda_core+lse"] == before + 1
    assert q.grad is not None and k.grad is not None and v.grad is not None
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    attention_ref(*leaves, causal=True).square().sum().backward()
    for t, r in zip((q, k, v), leaves):
        scale = float(r.grad.abs().max())
        assert float((t.grad - r.grad).abs().max()) <= 1e-4 * scale


def test_kernel_wrappers_refuse_to_cut_the_graph(cuda):
    """Each raw CUDA kernel wrapper raises under grad rather than return
    an output detached from the graph; `ops.ssd`, `ops.rglru` and
    `rglru_gated` train through the kernels' autograd Functions (their
    outputs carry a grad_fn); without grad the wrappers run as before."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_gated, rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator(device=cuda).manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)
    q = rand(1, 64, 2, 32).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q.detach(), q.detach())
    x, dt = rand(1, 64, 4, 16).requires_grad_(), rand(1, 64, 4).abs()
    a_log, b, c, d = rand(4), rand(1, 64, 1, 16), rand(1, 64, 1, 16), rand(4)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x, dt, a_log, b, c, d, chunk=32)
    before = ssd_scan.launches
    y, _ = ops.ssd(x, dt, a_log, b, c, d, chunk=32)
    assert y.grad_fn is not None and ssd_scan.launches == before + 1
    a = torch.rand(2, 16, 64, device=cuda).requires_grad_()
    gx, h0 = rand(2, 16, 64), torch.zeros(2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        rglru_scan(a, gx, h0)
    xr = rand(2, 16, 64).requires_grad_()
    r, i, lam = rand(2, 16, 64), rand(2, 16, 64), rand(64)
    before = rglru_scan.launches
    for hs, _ in (rglru_gated(xr, r, i, lam), ops.rglru(xr, r, i, lam)):
        assert hs.grad_fn is not None
    assert rglru_scan.launches == before + 2
    with torch.no_grad():
        flash_attention(q, q, q)
        ssd_scan(x, dt, a_log, b, c, d, chunk=32)
        rglru_gated(xr, r, i, lam)


# tests/test_kernels.py's SSD cases (B, S, H, P, N, chunk), then a chunk
# of 256 whose masked triangle overflows
SSD_GRAD_CASES = [(2, 64, 4, 16, 32, 16, False),
                  (1, 128, 8, 32, 64, 32, False),
                  (2, 96, 4, 64, 16, 32, False),
                  (1, 512, 2, 64, 128, 256, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_GRAD_CASES, ids=str)
def test_ssd_scan_fn_grads_on_card(cuda, case, dtype):
    """`SSDScanFn` on the card: one kernel launch on the dtype's route;
    y within the kernel bars of the plain version; the six gradients
    (with a gradient of h_final) within 1e-6 of each one's max |g| of
    autograd through `ssd_chunked` on the same inputs, all finite. The
    backward is that function's autodiff, recomputed from the inputs, so
    the gradients check the Function's wiring; the launch and y check
    the kernel."""
    from repro_torch.kernels.ref import ssd_chunked
    from repro_torch.kernels.ssd_scan import ROUTES, SSDScanFn, ssd_scan
    B, S, H, P, N, Q, overflow = case
    dt = getattr(torch, dtype)
    args = _ssd_inputs(case[:6], dt, cuda, seed=sum(case[:6]),
                       overflow=overflow)
    gen = torch.Generator(device=cuda).manual_seed(3)
    dy = torch.randn(B, S, H, P, generator=gen, device=cuda).to(dt)
    dh = torch.randn(B, H, P, N, generator=gen, device=cuda)
    before = ssd_scan.route_launches[ROUTES[dt]]
    leaves = [t.clone().requires_grad_() for t in args]
    y, h = SSDScanFn.apply(*leaves, Q)
    got = torch.autograd.grad([y, h], leaves, [dy, dh])
    assert ssd_scan.route_launches[ROUTES[dt]] == before + 1
    plain = [t.clone().requires_grad_() for t in args]
    py, ph = ssd_chunked(*plain, chunk=Q)
    want = torch.autograd.grad([py, ph], plain, [dy, dh])
    tol = 5e-3 if dtype == "float32" else 1e-1
    torch.testing.assert_close(y.float(), py.float(), atol=tol, rtol=tol)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and bool(torch.isfinite(g).all())
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
def test_rglru_scan_fn_backward_on_card(cuda, case, dtype):
    """`RGLRUScanFn` on the card: two launches (forward, and the reverse
    scan of the backward) on the route of the shape; on the ring route
    (da, dgx, dh0) bit-equal to the plain reverse loop
    `rglru_scan_bwd_torch` on the same inputs, on the column route
    within 1e-5 of max |g|; in float32 `rglru_gated`'s gradients within
    1e-5 of max |g| of autograd through `rglru_ref`."""
    from repro_torch.kernels.ref import (rglru_gates, rglru_ref,
                                         rglru_scan_bwd_torch)
    from repro_torch.kernels.rglru_scan import (RGLRUScanFn, rglru_gated,
                                                rglru_scan, route)
    B, S, W = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(case))

    def f(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=cuda)
    x, r, i, lam, h0, dy, dl = (f(B, S, W), f(B, S, W), f(B, S, W), f(W),
                                f(B, W), f(B, S, W), f(B, W))
    a, gx = rglru_gates(x.to(dt), r.to(dt), i.to(dt), lam)
    a = a.to(dt)
    path = route(a, gx)
    before = rglru_scan.route_launches[path]
    leaves = [t.clone().requires_grad_() for t in (a, gx, h0)]
    hs, hl = RGLRUScanFn.apply(*leaves)
    got = torch.autograd.grad([hs, hl], leaves, [dy, dl])
    assert rglru_scan.route_launches[path] == before + 2
    want = rglru_scan_bwd_torch(a, hs.detach(), h0, dy, dl)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if path == "ring":
            assert torch.equal(g, w)
        else:
            scale = float(w.float().abs().max())
            assert float((g.float() - w.float()).abs().max()) <= 1e-5 * scale
    if dtype == "float32":
        leaves = [t.clone().requires_grad_() for t in (x, r, i, lam, h0)]
        got = torch.autograd.grad(rglru_gated(*leaves[:4], h0=leaves[4]),
                                  leaves, [dy, dl])
        plain = [t.clone().requires_grad_() for t in (x, r, i, lam, h0)]
        want = torch.autograd.grad(rglru_ref(*plain[:4], h0=plain[4]),
                                   plain, [dy, dl])
        for g, w in zip(got, want):
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b",
                                  "mamba2-2.7b", "recurrentgemma-9b",
                                  "whisper-base"])
def test_train_step_on_card_equals_cpu(cuda, arch):
    """One AdamW train step (2 microbatches) of each family's smoke config
    in float32 from the same state on the card and on the CPU (OLMoE:
    the accumulating dispatch's backward and `lb_loss` under
    `FlashAttentionFn`; Mamba-2: `SSDScanFn`; RecurrentGemma:
    `RGLRUScanFn` and the windowed flash; Whisper: the encoder's,
    decoder's and cross-attention's flash, frames split into the
    microbatches): the loss and grad_norm within 1e-3 relative,
    the first and second moments within 1e-3 of each leaf's max, the
    params within 1e-3 (allclose), and the updates themselves (params
    after minus before): within 1e-3 relative plus 1e-2 of the learning
    rate, save for at most 1e-4 of the entries (a gradient within
    rounding of 0 flips Adam's first step, of size lr); every attention
    of the card's step launched the flash kernel with lse, every SSD
    call its kernel, every RG-LRU scan its kernel forward and back."""
    import dataclasses

    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.api import get_model
    from repro_torch.models.params import flatten, tree_map
    from repro_torch.train import loop as TL
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
    model = get_model(cfg)
    opt = OptimizerConfig(warmup_steps=0)
    tcfg = TrainConfig(seq_len=64, global_batch=4, microbatch=2,
                       optimizer=opt)
    state = TL.init_state(model, tcfg.optimizer, 0, "cpu")
    card_state = tree_map(lambda t: t.to(cuda), state)
    batch = next(iter(SyntheticLM(cfg.vocab_size, 64, 4, seed=2)))
    if cfg.family == "encdec":
        batch["frames"] = np.random.default_rng(2).normal(
            size=(4, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    # (counter, route) -> launches a microbatch
    n_attn = {"ssm": 0, "hybrid": cfg.n_layers // 3,
              "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}.get(
                  cfg.family, cfg.n_layers)
    per_micro = {(flash_attention, "cuda_core+lse"): n_attn,
                 (ssd_scan, "cuda_core"): cfg.n_layers * (cfg.family == "ssm"),
                 (rglru_scan, "ring"): 2 * (cfg.n_layers - n_attn) * (
                     cfg.family == "hybrid")}
    before = {k: k[0].route_launches[k[1]] for k in per_micro}
    step = TL.make_train_step(model, tcfg)
    got, gm = step(card_state, to_device(batch, cuda))
    torch.cuda.synchronize()
    for k, n in per_micro.items():
        assert k[0].route_launches[k[1]] == before[k] + 2 * n, k[1]
    p0 = {p: t.clone() for p, t in flatten(state["params"])}
    want, wm = step(state, to_device(batch, "cpu"))
    for k in ("loss", "grad_norm"):
        assert abs(float(gm[k]) - float(wm[k])) <= 1e-3 * abs(float(wm[k]))
    w = dict(flatten(want))
    off = n = 0
    for path, t in flatten(got):
        ref = w[path]
        if path.startswith("opt/"):
            scale = float(ref.abs().max())
            assert float((t.cpu() - ref).abs().max()) <= 1e-3 * scale, path
        elif path.startswith("params/"):
            torch.testing.assert_close(t.cpu(), ref, atol=1e-3, rtol=1e-3)
            before_p = p0[path[len("params/"):]]
            da, db = t.cpu() - before_p, ref - before_p
            off += int(((da - db).abs() > 1e-3 * db.abs() + 1e-2 * opt.lr)
                       .sum())
            n += ref.numel()
        else:
            assert torch.equal(t.cpu(), ref), path
    assert off <= 1e-4 * n, (off, n)
