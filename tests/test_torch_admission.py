"""The admission rounds: the port's plain versions against the Pallas kernel.

`admission_round_torch` must equal the reference's Pallas
`admission_round` (interpret mode, float64) exactly: (dst', struck',
want_total) are integers, and one flipped admission would change the
plan. `admission_rounds_torch`, the plain version of the port's
one-launch epoch, must equal that many successive Pallas rounds with the
planner's update of the free slots between them. The inputs force the
hard cases: nets rounded to quarters (ties between regions), random
strike masks, partly placed `dst`, and so few free slots that every
region is contended. `block_n` 7 runs the Pallas grid over many ragged
blocks, 8192 over one.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("jax.experimental.pallas")

import jax.numpy as jnp  # noqa: E402

from repro.cluster.placement_pallas import admission_round as pallas_round  # noqa: E402
from repro_torch.cluster.placement_kernel import (  # noqa: E402
    admission_round, admission_round_torch, admission_rounds,
    admission_rounds_torch)


def _inputs(N, R, seed):
    rng = np.random.default_rng(seed)
    net = np.round(rng.normal(0.0, 1.0, (N, R)) * 4) / 4
    assign = rng.integers(0, R, N).astype(np.int32)
    elig = rng.random(N) < 0.8
    dst = np.where(rng.random(N) < 0.25, rng.integers(0, R, N),
                   -1).astype(np.int32)
    struck = (rng.integers(0, 1 << R, N)
              & rng.integers(0, 1 << R, N)).astype(np.int32)
    remaining = rng.integers(0, max(2, N // (4 * R)), R).astype(np.int32)
    return net, assign, elig, dst, struck, remaining


def _torch_args(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("block_n", [7, 8192])
@pytest.mark.parametrize("N,R", [(61, 2), (250, 3), (1003, 5)])
def test_plain_round_equals_pallas_kernel(N, R, block_n):
    arrays = _inputs(N, R, seed=N + R)
    with jax.enable_x64(True):
        ref = pallas_round(*(jnp.asarray(a) for a in arrays),
                           block_n=block_n, interpret=True)
        ref = [np.asarray(x) for x in ref]
    got = admission_round_torch(*_torch_args(arrays))
    for name, r, g in zip(("dst", "struck", "want_total"), ref, got):
        assert g.dtype == torch.int32, name
        assert np.array_equal(r, g.numpy()), name
    # contended: some region had more wanters than free slots
    assert (ref[2] > arrays[5]).any()


@pytest.mark.parametrize("N,R,rounds", [(250, 3, 3), (1003, 5, 5),
                                         (777, 3, 1), (61, 2, 2)])
def test_plain_rounds_equal_successive_pallas_rounds(N, R, rounds):
    arrays = _inputs(N, R, seed=N + R + rounds)
    net, assign, elig, dst, struck, remaining = arrays
    wants, contended = [], False
    with jax.enable_x64(True):
        for _ in range(rounds):
            dst, struck, want = (np.asarray(x) for x in pallas_round(
                *(jnp.asarray(a) for a in (net, assign, elig, dst, struck,
                                           remaining)),
                block_n=64, interpret=True))
            contended |= bool((want > remaining).any())
            remaining = remaining - np.minimum(want, remaining)
            wants.append(want)
    got = admission_rounds_torch(*_torch_args(arrays), rounds)
    for name, r, g in zip(("dst", "struck", "want"),
                          (dst, struck, np.stack(wants)), got):
        assert g.dtype == torch.int32, name
        assert np.array_equal(r, g.numpy()), name
    assert contended, "no round was contended"


def test_wrapper_runs_the_plain_version_on_cpu_without_counting():
    args = _torch_args(_inputs(300, 3, seed=4))
    before = admission_rounds.launches
    got = admission_round(*args)
    want = admission_round_torch(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = admission_rounds(*args, 3)
    want = admission_rounds_torch(*args, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tuple(got[2].shape) == (3, 3)
    assert admission_rounds.launches == before


@pytest.mark.parametrize("bad", ["net_dtype", "eligible_dtype", "shape",
                                 "regions", "layout", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    net, assign, elig, dst, struck, rem = _torch_args(_inputs(40, 3, seed=1))
    if bad == "net_dtype":
        net = net.float()
    elif bad == "eligible_dtype":
        elig = elig.to(torch.int32)
    elif bad == "shape":
        dst = dst[:-1]
    elif bad == "regions":
        net = torch.zeros((40, 32), dtype=torch.float64)
    elif bad == "layout":
        net = torch.zeros((3, 40), dtype=torch.float64).t()
    else:
        net = net.to("meta")
    with pytest.raises(ValueError):
        admission_round(net, assign, elig, dst, struck, rem)
    with pytest.raises(ValueError):
        admission_rounds(net, assign, elig, dst, struck, rem, 3)


def test_kernel_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    from repro_torch import cuda_build
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path / "build")
    lib = cuda_build.library_path("admission_round")
    assert lib.parent == tmp_path / "build"
    assert lib.name.startswith("libadmission_round-") and lib.suffix == ".so"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(["admission_round"])
    assert not lib.exists()
