"""The elasticity layer against the reference: `simulate_elastic_torch`
against the NumPy layer (`simulate_elastic`) and the reference's
`simulate_elastic_jax`, on dense and indexed carbon, with level counts
bit-equal and floats within 1e-6; and the fixed-order sums the greedy
compares with its budget."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_torch_reference import jax_reference  # noqa: E402,F401

from repro.core.elasticity import (ElasticityConfig as RefEC,  # noqa: E402
                                   simulate_elastic)
from repro_torch import devmath  # noqa: E402
from repro_torch.core.elasticity import ElasticityConfig  # noqa: E402
from repro_torch.core.elasticity import \
    simulate_elastic as port_simulate_elastic  # noqa: E402
from repro_torch.core.elasticity_torch import \
    simulate_elastic_torch  # noqa: E402
from repro_torch.devmath import (BLOCK, budget_admits,  # noqa: E402
                                 divide, ordered_cumsum, ordered_sum)

TOL = 1e-6
CFG = dict(k_levels=4, unit_capacity=1.5, base_w=50.0, peak_w=200.0,
           min_level=1, max_step=1)


def _inputs(T=48, N=12, R=3, seed=0):
    rng = np.random.default_rng(seed)
    demand = np.abs(rng.normal(3.0, 1.5, (T, N)))
    region_mat = np.abs(rng.normal(300.0, 150.0, (T, R)))
    region_mat[5] = 0.0                      # zero-intensity epoch
    codes = rng.integers(0, R, (T, N)).astype(np.int32)
    dense = region_mat[np.arange(T)[:, None], codes]
    return demand, region_mat, codes, dense


def _assert_same(want, got):
    np.testing.assert_array_equal(got.levels, want.levels)
    scale = max(float(np.max(np.abs(want.served_w))), 1.0)
    assert np.max(np.abs(want.served_w - got.served_w)) <= TOL * scale
    assert np.max(np.abs(want.backlog - got.backlog)) <= TOL * scale
    for f in ("emissions_g", "est_emissions_g"):
        a, b = getattr(want, f), getattr(got, f)
        assert abs(a - b) <= TOL * max(abs(a), 1.0), f
    assert got.cap_violations == want.cap_violations
    assert (got.summary()["elastic_level_epochs"]
            == want.summary()["elastic_level_epochs"])


@pytest.mark.parametrize("budget,shape", [(None, False), (2.0, False),
                                          (2.0, True)])
@pytest.mark.parametrize("mode", ["oracle", "persistence", "forecast"])
def test_levels_equal_reference_dense_and_indexed(jax_reference, mode,
                                                  budget, shape):
    from repro.core.elasticity_jax import simulate_elastic_jax
    demand, region_mat, codes, dense = _inputs()
    kw = dict(budget_g_per_epoch=budget, forecast=mode, shape_budget=shape,
              **CFG)
    ref_cfg, cfg = RefEC(**kw), ElasticityConfig(**kw)
    # dense carbon is forecast per container, indexed carbon per region
    # and then gathered, on both sides
    got = simulate_elastic_torch(demand, dense, cfg, 300.0, record=True,
                                 device="cpu")
    _assert_same(simulate_elastic(demand, dense, ref_cfg, 300.0), got)
    _assert_same(simulate_elastic_jax(demand, dense, ref_cfg, 300.0,
                                      record=True), got)
    got = simulate_elastic_torch(demand, (region_mat, codes), cfg, 300.0,
                                 record=True, device="cpu")
    _assert_same(simulate_elastic_jax(demand, (region_mat, codes), ref_cfg,
                                      300.0, record=True), got)
    if budget is not None:
        assert got.summary()["elastic_level_epochs"] < simulate_elastic(
            demand, dense, RefEC(forecast=mode, **CFG), 300.0).levels.sum()


def test_forecast_and_budget_overrides_match_reference(jax_reference):
    """The sweep's path: a carbon forecast on an observed (T, R) matrix
    and a precomputed budget series."""
    from repro.core.elasticity_jax import simulate_elastic_jax
    demand, region_mat, codes, _ = _inputs(T=72, N=20, seed=4)
    observed = region_mat * np.random.default_rng(5).uniform(0.7, 1.3,
                                                             region_mat.shape)
    kw = dict(budget_g_per_epoch=2.5, forecast="forecast", shape_budget=True,
              **CFG)
    budget = np.linspace(1.5, 3.5, 72)
    want = simulate_elastic_jax(demand, (region_mat, codes), RefEC(**kw),
                                3600.0, record=True, budget_series=budget,
                                carbon_forecast=observed)
    got = simulate_elastic_torch(demand, (region_mat, codes),
                                 ElasticityConfig(**kw), 3600.0, record=True,
                                 budget_series=budget,
                                 carbon_forecast=observed, device="cpu")
    _assert_same(want, got)


@pytest.mark.parametrize("shape", [False, True])
def test_levels_past_one_block_equal_numpy(shape):
    """300 containers x 4 levels: the greedy's budget cut sums 1,200
    entries, past one fixed-order block, and still admits the levels
    the reference's and the port's NumPy layers admit."""
    demand, region_mat, codes, dense = _inputs(T=48, N=300, seed=7)
    kw = dict(budget_g_per_epoch=50.0, forecast="forecast",
              shape_budget=shape, **CFG)
    assert 300 * CFG["k_levels"] > BLOCK
    got = simulate_elastic_torch(demand, dense, ElasticityConfig(**kw),
                                 300.0, record=True, device="cpu")
    _assert_same(simulate_elastic(demand, dense, RefEC(**kw), 300.0), got)
    _assert_same(port_simulate_elastic(demand, dense, ElasticityConfig(**kw),
                                       300.0), got)
    uncapped = simulate_elastic(demand, dense, RefEC(forecast="forecast",
                                                     **CFG), 300.0)
    assert got.levels.sum() < uncapped.levels.sum()


def _near_cut(L, seed):
    """Non-negative grams and a budget that the block order and NumPy's
    left fold decide differently at one prefix."""
    rng = np.random.default_rng(seed)
    mand = np.where(rng.random(L) < 0.3, rng.random(L), 0.0)
    gs = rng.random(L) * rng.choice([1e-3, 1.0, 1e2], L)
    seq = np.cumsum(mand)[-1] + np.cumsum(gs)
    blk = (ordered_sum(torch.as_tensor(mand))
           + ordered_cumsum(torch.as_tensor(gs))).numpy()
    k = int(np.flatnonzero(seq != blk)[L // 7 % np.sum(seq != blk)])
    return mand, gs, seq, blk, min(seq[k], blk[k])


@pytest.mark.parametrize("L", [2 * BLOCK + 5, 5 * BLOCK + 3, 40_000])
def test_budget_admits_is_numpys_cut(L):
    """Where the block order lies within rounding of the budget, the cut
    is formed again as NumPy's left fold; elsewhere the block order's
    decision already is NumPy's."""
    mand, gs, seq, blk, budget = _near_cut(L, L)
    live = np.random.default_rng(1).random(L) < 0.9
    live[np.flatnonzero(seq != blk)] = True
    assert not np.array_equal(blk <= budget, seq <= budget)
    before = devmath.refolds
    got = budget_admits(torch.as_tensor(mand), torch.as_tensor(gs), budget,
                        torch.as_tensor(live))
    assert devmath.refolds == before + 1
    assert np.array_equal(got.numpy(), live & (seq <= budget))
    j = L // 2 + int(np.argmax(gs[L // 2 + 1:] > 50.0))
    far = 0.5 * (seq[j] + seq[j + 1])   # 25 from any prefix sum
    got = budget_admits(torch.as_tensor(mand), torch.as_tensor(gs), far,
                        torch.as_tensor(live))
    assert devmath.refolds == before + 1
    assert np.array_equal(got.numpy(), live & (seq <= far))


def test_record_false_keeps_the_summary():
    demand, region_mat, codes, _ = _inputs(seed=2)
    cfg = ElasticityConfig(budget_g_per_epoch=1.5, **CFG)
    a = simulate_elastic_torch(demand, (region_mat, codes), cfg, 300.0,
                               record=True, device="cpu")
    b = simulate_elastic_torch(demand, (region_mat, codes), cfg, 300.0,
                               device="cpu")
    assert b.levels.shape == (0, demand.shape[1])
    assert a.summary() == b.summary()


def test_shape_validation():
    demand, region_mat, codes, _ = _inputs()
    cfg = ElasticityConfig(**CFG)
    with pytest.raises(ValueError):
        simulate_elastic_torch(demand[0], region_mat, cfg, device="cpu")
    with pytest.raises(ValueError):
        simulate_elastic_torch(demand, (region_mat[:10], codes), cfg,
                               device="cpu")
    with pytest.raises(ValueError):
        simulate_elastic_torch(demand, np.zeros((4, 4)), cfg, device="cpu")


@pytest.mark.parametrize("L", [1, 2, 7, BLOCK])
def test_ordered_sums_are_numpys_left_fold(L):
    rng = np.random.default_rng(L)
    x = rng.random(L) * rng.choice([1e-3, 1.0, 1e4], L)
    assert np.array_equal(ordered_cumsum(torch.as_tensor(x)).numpy(),
                          np.cumsum(x))
    assert ordered_sum(torch.as_tensor(x)).item() == np.cumsum(x)[-1]
    cols = np.stack([x, x[::-1]], axis=1)
    assert np.array_equal(ordered_sum(torch.as_tensor(cols)).numpy(),
                          np.cumsum(cols, axis=0)[-1])


@pytest.mark.parametrize("L", [BLOCK + 1, 5 * BLOCK + 3])
def test_ordered_sums_past_one_block(L):
    """Past a block: a left fold within each block, then over the block
    totals; the sum is the cumulative sum's last entry."""
    x = np.random.default_rng(L).random(L)
    got = ordered_cumsum(torch.as_tensor(x)).numpy()
    blocks = [np.cumsum(x[i:i + BLOCK]) for i in range(0, L, BLOCK)]
    offsets = np.cumsum([b[-1] for b in blocks])
    want = np.concatenate([blocks[0]] + [b + o for b, o in
                                         zip(blocks[1:], offsets[:-1])])
    assert np.array_equal(got, want)
    assert ordered_sum(torch.as_tensor(x)).item() == got[-1]
    assert np.max(np.abs(got - np.cumsum(x))) <= 1e-12 * got[-1]


def test_divide_is_the_true_quotient():
    x = np.random.default_rng(0).random(10_000) * 1000.0
    for c in (3600.0, 1000.0, 0.3):
        assert np.array_equal(divide(torch.as_tensor(x), c).numpy(), x / c)
