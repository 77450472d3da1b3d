"""The benchmark's yardstick against hand-worked counts, and the bound
rule: no bound counts a recompute."""
from __future__ import annotations

import pytest

import portbench_cases  # noqa: F401  (puts the repository on sys.path)
from portbench.roofline import counts as C

SMOLLM = portbench_cases.harness.load_json(
    portbench_cases.harness.BENCH / "configs" / "smollm-135m.json")["model"]
MAMBA = portbench_cases.harness.load_json(
    portbench_cases.harness.BENCH / "configs" / "mamba2-2.7b.json")["model"]


def test_attention_backward_at_smollm_microbatch():
    # (8, 4096, 9:3, 64), causal: 4096 * 4097 / 2 = 8,390,656 pairs
    pairs = 8_390_656
    assert C.causal_pairs(4096) == pairs
    flops, nbytes = C.attn_bwd(8, 4096, 9, 3, 64)
    assert flops == 8 * 8 * 9 * 64 * pairs == 309_313_142_784
    q = 8 * 4096 * 9 * 64 * 2          # q, out, dout, dq: bf16
    kv = 8 * 4096 * 3 * 64 * 2         # k, v, dk, dv: bf16
    lse = 8 * 9 * 4096 * 4
    assert nbytes == 4 * q + 4 * kv + lse == 202_506_240
    # FLOP-bound: 0.3128 ms at 989 TFLOP/s
    assert C.bound_s(flops, nbytes) == pytest.approx(flops / 989e12)
    assert C.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.31275, rel=1e-4)


def test_flash_forward_with_lse():
    flops, nbytes = C.flash_fwd(8, 4096, 9, 3, 64)
    assert flops == 4 * 8 * 9 * 64 * 8_390_656
    assert nbytes == (2 * 8 * 4096 * 9 * 64 + 2 * 8 * 4096 * 3 * 64) * 2 \
        + 8 * 9 * 4096 * 4


def test_ssd_forward_and_backward_at_mamba_microbatch():
    # (2, 4096), 80 heads of 64, state 128, chunk 256: 16 chunks a row
    per_chunk = 2 * 256 * 256 * 128 + 80 * (2 * 256 * 256 * 64
                                            + 4 * 256 * 64 * 128)
    fwd, fbytes = C.ssd_fwd(2, 4096, 80, 64, 128, 256)
    assert fwd == 2 * 16 * per_chunk == 43_486_543_872
    assert fbytes == 2 * (2 * 2 * 4096 * 80 * 64 + 2 * 2 * 4096 * 128) \
        + 4 * (2 * 4096 * 80 + 2 * 80 + 2 * 80 * 64 * 128)
    bwd, bbytes = C.ssd_bwd(2, 4096, 80, 64, 128, 256)
    assert bwd == 2 * fwd
    assert bbytes == 2 * (2 * 2 * 4096 * 80 * 64 + 4 * 2 * 4096 * 128) \
        + 2 * 4 * 2 * 4096 * 80


def test_no_bound_counts_recompute():
    """The backward bounds are 2 x their forward's products, where the
    program's cost table counts its recomputing backwards at 2.5 x
    (attention) and 3 x (SSD)."""
    from repro_torch.kernels import cost
    f_fwd, _ = C.flash_fwd(8, 4096, 9, 3, 64)
    f_bwd, _ = C.attn_bwd(8, 4096, 9, 3, 64)
    assert f_bwd == 2 * f_fwd
    prog, _ = cost.attention_backward(8, 4096, 4096, 9, 3, 64, 2, True, 0)
    assert f_bwd == prog * 8 // 10
    s_fwd, _ = C.ssd_fwd(2, 4096, 80, 64, 128, 256)
    s_bwd, _ = C.ssd_bwd(2, 4096, 80, 64, 128, 256)
    prog, _ = cost.ssd_backward(2, 4096, 80, 64, 128, 256, 2)
    assert s_bwd == 2 * s_fwd == prog * 2 // 3
    # the forward kernels are counted as the program counts them
    assert (f_fwd, C.flash_fwd(8, 4096, 9, 3, 64)[1]) == cost.flash_attention(
        8, 4096, 4096, 9, 3, 64, 2, True, 0, lse=True)
    assert C.ssd_fwd(2, 4096, 80, 64, 128, 256) == cost.ssd_scan(
        2, 4096, 80, 64, 128, 256, 2)


@pytest.mark.parametrize("name,family,model", [
    ("smollm-135m", "dense", SMOLLM), ("mamba2-2.7b", "ssm", MAMBA)])
def test_model_flops_match_the_programs_count(name, family, model):
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.dryrun_lib import train_model_flops
    from repro_torch.models.api import get_model
    m = get_model(get_arch(name).full)
    assert C.param_count(family, model) == m.param_count()
    assert C.train_step_flops(family, model, 4, 4096) == pytest.approx(
        train_model_flops(m, 4, 4096), rel=1e-12)


def test_smollm_step_flops_by_hand():
    n = 134_515_008
    mix = 30 * 4 * 32 * 9 * 64 * 8_390_656
    assert C.train_step_flops("dense", SMOLLM, 32, 4096) == \
        6.0 * n * 32 * 4096 + 3 * mix


def test_serve_flops_count_the_head_once_a_row():
    n = C.param_count("ssm", MAMBA)
    e = 50_280 * 2560
    mix = C.mixing_fwd_flops("ssm", MAMBA, 16, 2048)
    got = C.serve_flops("ssm", MAMBA, 16, 2048, 2)
    assert got == 2.0 * (n - e) * 16 * 2048 + mix + 2.0 * e * 16 \
        + 2.0 * n * 16 * 2
    assert got < 2.0 * n * 16 * (2048 + 2) + mix


def test_bound_takes_the_slower_of_flops_and_bytes():
    assert C.bound_s(989e12, 0) == pytest.approx(1.0)
    assert C.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert C.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


# (rows, seq): (token-mixing products, train step flops, serve flops with 2
# decode steps), as the counts read before each family's moved into a file
# of its own (roofline/<family>.py): they must stay bit-equal
PINNED = {
    "smollm-135m": ("dense", 134_515_008, 28_311_552, {
        (32, 4096): (18558788567040, 161463272472576.0, 46418417197056.0),
        (256, 512): (2323812188160, 112758343335936.0, 30316649840640.0),
        (4, 4096): (2319848570880, 20182909059072.0, 5802302149632.0),
        (16, 2048): (2320414801920, 33407971098624.0, 9290079424512.0)}),
    "mamba2-2.7b": ("ssm", 2_702_579_200, 128_716_800, {
        (32, 4096): (44530220924928, 2258985428189184.0, 719606973923328.0),
        (256, 512): (44530220924928, 2258985428189184.0, 722086150012928.0),
        (4, 4096): (5566277615616, 282373178523648.0, 89950871740416.0),
        (16, 2048): (11132555231232, 564746357047296.0,
                     179990285484032.0)}),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_family_counts_are_pinned(name):
    family, n, e, shapes = PINNED[name]
    model = SMOLLM if family == "dense" else MAMBA
    assert C.family(family).__name__ == f"portbench.roofline.{family}"
    assert C.param_count(family, model) == n
    assert C.family(family).active_params(model) == n
    assert C.embed_params(family, model) == e
    for (rows, seq), (mix, train, serve) in shapes.items():
        assert C.mixing_fwd_flops(family, model, rows, seq) == mix
        assert C.train_step_flops(family, model, rows, seq) == train
        assert C.serve_flops(family, model, rows, seq, 2) == serve
