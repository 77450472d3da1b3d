"""Quickstart: train a small model, checkpoint it, and serve from it
(the reference's `examples/quickstart.py`).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
        [--steps 60]
"""
import sys
import tempfile

import numpy as np

from repro_torch.config import OptimizerConfig, TrainConfig, parse_cli
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import markov_stream
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.serve.engine import ServeEngine, throughput_tokens_per_s
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import loop as TL


def main(argv=None) -> dict:
    args = parse_cli(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.get("device", "cuda"))
    steps = int(args.get("steps", 60))

    # 1. pick an architecture (its reduced config)
    spec = get_arch("smollm-135m")
    model = get_model(spec.smoke)
    print(f"arch={spec.arch_id} (smoke): {model.param_count():,} params")

    # 2. train on a learnable synthetic stream
    tcfg = TrainConfig(seq_len=64, global_batch=8, steps=steps, log_every=20,
                       optimizer=OptimizerConfig(lr=3e-3, warmup_steps=10,
                                                 total_steps=steps))
    data = markov_stream(spec.smoke.vocab_size, tcfg.seq_len,
                         tcfg.global_batch, temperature=0.2)
    out = TL.run(model, tcfg, data, device=device)
    losses = [h["loss"] for h in out["history"]]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")

    # 3. checkpoint
    with tempfile.TemporaryDirectory() as d:
        info = CKPT.save(d, out["state"], step=tcfg.steps)
        print(f"checkpoint: {info['bytes']/1e6:.1f} MB in "
              f"{info['total_s']*1e3:.0f} ms")

    # 4. serve a few generations from the trained params
    engine = ServeEngine(model, params=out["state"]["params"], device=device)
    prompts = np.random.default_rng(0).integers(
        0, spec.smoke.vocab_size, (4, 16)).astype(np.int32)
    gen = engine.generate(prompts, 12)
    tp = throughput_tokens_per_s(gen["stats"])
    print(f"generated {gen['tokens'].shape}; decode "
          f"{tp['decode_tok_s']:.0f} tok/s")
    print("sample:", gen["tokens"][0].tolist())
    return {"params": model.param_count(), "loss_first": losses[0],
            "loss_last": losses[-1], "checkpoint_bytes": info["bytes"],
            "tokens": gen["tokens"], "decode_tok_s": tp["decode_tok_s"]}


if __name__ == "__main__":
    main()
