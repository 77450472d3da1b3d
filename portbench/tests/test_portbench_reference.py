"""The plain references against the program's CPU path at the smoke
widths, both in float32: the loss, every gradient and one AdamW step of
training; the prefill's and a decode step's logits of serving."""
from __future__ import annotations

import pytest
import torch

import portbench_cases
from portbench.reference import common as C
from portbench.reference import drive

CONFIGS = {"dense": "smollm-135m.train-4k", "ssm": "mamba2-2.7b.train-4k"}


def setup(family):
    from repro_torch.models.api import get_model
    kw = portbench_cases.small(CONFIGS[family])
    m = kw["conf"]["model"]
    layout = drive.family(family).layout(m)
    flat = C.init_params(layout, portbench_cases.SEED, "cpu")
    return m, layout, flat, get_model(kw["model_cfg"]), kw["work"]["traffic"]


def close(got, want, tol=2e-5):
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_loss_gradients_and_adamw_step(family):
    from repro_torch.config import OptimizerConfig
    from repro_torch.train.optimizer import adamw_init, adamw_update
    m, layout, flat, model, traffic = setup(family)
    batch = C.train_batch(portbench_cases.SEED, 0, 4, 32, m["vocab_size"],
                          "cpu")
    leaves = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss, _ = model.loss(C.nest(leaves), batch)
    loss.backward()

    P, ref_leaves = drive._split({k: v.clone() for k, v in flat.items()})
    nll = drive.family(family).nll_sum(m, P, batch["tokens"],
                                       batch["labels"], C.exact)
    (nll / batch["labels"].numel()).backward()
    close(loss.detach(), nll.detach() / batch["labels"].numel())
    for path, t in leaves.items():
        want = (torch.stack([lp[path[7:]].grad for lp in P["layers"]])
                if path.startswith("layers/") else P[path].grad)
        close(t.grad, want)

    opt = traffic["optimizer"]
    cfg = OptimizerConfig(lr=opt["lr"], warmup_steps=0, schedule="constant",
                          b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                          weight_decay=opt["weight_decay"],
                          grad_clip=opt["grad_clip"])
    params = C.nest({k: v.detach().clone() for k, v in leaves.items()})
    grads = C.nest({k: v.grad.clone() for k, v in leaves.items()})
    new, _, metrics = adamw_update(cfg, grads, adamw_init(params), params,
                                   torch.zeros((), dtype=torch.int32))
    mom = [torch.zeros_like(p) for p in ref_leaves]
    vel = [torch.zeros_like(p) for p in ref_leaves]
    gnorm = C.adamw_step(opt, 0, ref_leaves, mom, vel)
    assert float(metrics["grad_norm"]) == pytest.approx(gnorm, rel=1e-5)
    for path, t in C.flat(new).items():
        want = (torch.stack([lp[path[7:]].detach() for lp in P["layers"]])
                if path.startswith("layers/") else P[path].detach())
        close(t, want)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_prefill_and_decode_logits(family):
    m, layout, flat, model, _ = setup(family)
    params = model.prepare(C.nest(flat))
    prompt = C.token_rows(portbench_cases.SEED, 1, 2, 32, m["vocab_size"],
                          "cpu")
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompt}, pad_to=34)
        nxt = logits.argmax(-1)
        step, _ = model.decode(params, cache, nxt)
    rows = torch.cat([prompt, nxt[:, None]], 1)
    ref = drive.served_logits(family, m, flat, rows, 2)
    close(logits.float(), ref[:, 0])
    close(step.float(), ref[:, 1])
    assert drive.widest_gap(ref, torch.stack([nxt, step.argmax(-1)], 1)) \
        == pytest.approx(0.0, abs=1e-5)
