"""A cell on several cards: one process a card, rank 0 in the calling
process and the others spawned, in one process group. Here on the CPU
over gloo, 4 ranks, from a manifest that gives the small SmolLM 4k cell
4 chips: the run reads ``correct``, its losses are the one-rank run's
to float32 rounding, each training fault still reads not ``correct``,
a rank that raises fails the run in bounded time, and so does a rank
that holds a forbidden module once its windows have closed."""
from __future__ import annotations

import copy
import time

import pytest

import portbench_cases
from portbench import harness

CELL = "smollm-135m.train-4k"
# 2 rows of each microbatch a rank: the batch axis splits over the 4
# ranks (the small traffic's microbatch of 2 would not), and the half
# batch fault leaves each rank 1
DP4 = {"global_batch": 16, "microbatch": 8}


def _on(chips: int) -> dict:
    man = copy.deepcopy(portbench_cases.manifest())
    harness.cell(man, CELL)["chips"] = chips
    return man


def _run(chips: int, traffic: dict = DP4, **kw) -> dict:
    return portbench_cases.run_small(CELL, man=_on(chips), traffic=traffic,
                                     **kw)


def test_four_ranks_read_correct_with_the_one_rank_losses():
    losses, rows = {}, {}

    def peek(driver, chips):
        losses[chips] = list(driver.port["loss"])
        rows[chips] = driver.card_rows
    for chips in (4, 1):
        res = _run(chips, peek=lambda d, n=chips: peek(d, n))
        assert res["correct"], res["compared"]
        assert res["device"]["count"] == chips
        assert "memory_peak_bytes" in res["device"]
        assert res["metrics"]["setup_s"]["value"] > 0
        assert res["metrics"]["train_tok_s"]["value"] > 0
    assert len(losses[4]) == len(losses[1]) == 3
    assert losses[4] == pytest.approx(losses[1], rel=1e-6)
    # the kernels' batch, which the roofline readers take: a card's rows
    assert rows == {4: DP4["microbatch"] // 4, 1: DP4["microbatch"]}


@pytest.mark.parametrize("fault", [portbench_cases.unchanged_state,
                                   portbench_cases.half_batch],
                         ids=["unchanged_state", "half_batch"])
def test_training_fault_on_four_ranks_is_not_correct(fault):
    assert not _run(4, faults=[fault])["correct"]


def test_a_rank_that_raises_in_setup_fails_the_run():
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 exited with 1"):
        _run(4, faults=[portbench_cases.rank_1_raises_in_setup])
    assert time.perf_counter() - t < 180


def test_a_rank_that_loads_a_forbidden_module_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 exited with 3"):
        _run(4, faults=[portbench_cases.rank_1_loads_forbidden])


def test_the_traffic_s_model_axis_lays_the_mesh():
    rows = {}
    res = _run(4, traffic=dict(DP4, model_axis=2),
               peek=lambda d: rows.update(card=d.card_rows))
    assert res["correct"], res["compared"]
    # a (data 2, model 2) mesh: the batch splits over the data axis alone
    assert rows == {"card": DP4["microbatch"] // 2}
