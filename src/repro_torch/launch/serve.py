"""Serving launcher: batched generation with seeded random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --smoke false --batch 4 --prompt-len 2048 --new-tokens 32 [--device cuda]

``--arch``: any architecture of `repro_torch.configs` (dense, MoE,
Mamba-2, RecurrentGemma, Whisper; an encoder-decoder is fed zero
frames). ``--smoke true`` (the default) serves its reduced config;
``--smoke false`` the published one, where ``--layers N`` cuts the depth
(dbrx-132b does not fit one 80 GB card at its 40 layers; it serves at
2). ``--device`` defaults to ``cuda`` and fails without a card. Prints
the kernel launches of the run (none on the CPU).
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from repro_torch.config import parse_cli
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.api import get_model
from repro_torch.serve.engine import ServeEngine, throughput_tokens_per_s


def main(argv=None) -> int:
    args = parse_cli(argv if argv is not None else sys.argv[1:])
    spec = get_arch(args.get("arch", "smollm-135m"))
    cfg = spec.smoke if args.get("smoke", "true") != "false" else spec.full
    if "layers" in args:
        cfg = dataclasses.replace(cfg, n_layers=int(args["layers"]))
    engine = ServeEngine(get_model(cfg), device=args.get("device", "cuda"))
    engine.load(int(args.get("seed", 0)))
    B = int(args.get("batch", 4))
    S = int(args.get("prompt-len", 32))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    kernels = (flash_attention, ssd_scan, rglru_scan)
    before = [k.launches for k in kernels]
    out = engine.generate(prompts, int(args.get("new-tokens", 16)),
                          duty=float(args.get("duty", 1.0)))
    tp = throughput_tokens_per_s(out["stats"])
    flash, ssd, rglru = (k.launches - n for k, n in zip(kernels, before))
    print(f"{cfg.name} on {engine.device}: generated {out['tokens'].shape} "
          f"tokens, {flash} flash kernel launches, {ssd} ssd_scan, {rglru} "
          f"rglru_scan")
    print(f"prefill {tp['prefill_tok_s']:.0f} tok/s, decode "
          f"{tp['decode_tok_s']:.0f} tok/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
