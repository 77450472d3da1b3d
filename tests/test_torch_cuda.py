"""Tests that need the card: the CUDA admission kernel against its plain
version, and card-vs-CPU plan equality. They skip without a GPU. On the
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


@pytest.mark.parametrize("N,R", [(1, 2), (1023, 3), (1025, 3), (12_345, 5),
                                 (100_000, 31)])
def test_admission_kernel_equals_plain_version(cuda, N, R):
    from repro_torch.cluster.placement_kernel import (admission_round,
                                                      admission_round_torch)
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
    before = admission_round.launches
    got = admission_round(*args)
    want = admission_round_torch(*args)
    torch.cuda.synchronize()
    assert admission_round.launches == before + 2
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
