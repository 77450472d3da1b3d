"""Training launcher (the reference's `src/repro/launch/train.py`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --smoke true --steps 50 --global-batch 8 --seq-len 128 \
      [--carbon-target 80 --region NL] [--device cuda]

Trains on `markov_stream` tokens (seeded weights and data). With
``--carbon-target`` the job runs inside a Carbon Container (live
enforcement: duty-cycling, migration between slices, suspend/resume on a
virtual clock of ``--sim-step-s`` seconds a step); every slice of the
TPU v5e family maps onto the one device, as the reference's demo maps
them when it has one device. ``--device`` defaults to ``cuda`` and fails
without a card; ``--device cpu`` runs on the CPU. Every family but the
encoder-decoder trains here; Whisper's batches need ``frames``, which
`markov_stream` does not make, so it trains through
`train.loop.make_train_step` with frames its caller builds.
"""
from __future__ import annotations

import sys
import tempfile

from repro_torch.config import (CarbonConfig, OptimizerConfig, TrainConfig,
                                parse_cli)
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import markov_stream
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.train import loop as TL


def main(argv=None) -> int:
    args = parse_cli(argv if argv is not None else sys.argv[1:])
    arch = args.get("arch", "smollm-135m")
    spec = get_arch(arch)
    cfg = spec.smoke if args.get("smoke", "true") != "false" else spec.full
    if cfg.family == "encdec":
        raise SystemExit(f"{arch} trains on batches with 'frames' (B, "
                         f"{cfg.enc_seq}, {cfg.d_model}), which this "
                         f"launcher's markov_stream does not make; call "
                         f"train.loop.make_train_step with them")
    device = resolve_device(args.get("device", "cuda"))
    model = get_model(cfg)
    tcfg = TrainConfig(
        seq_len=int(args.get("seq-len", 128)),
        global_batch=int(args.get("global-batch", 8)),
        steps=int(args.get("steps", 50)),
        microbatch=int(args.get("microbatch", 0)),
        remat=args.get("remat", "none"),
        optimizer=OptimizerConfig(
            lr=float(args.get("lr", 1e-3)),
            warmup_steps=int(args.get("warmup", 10)),
            total_steps=int(args.get("steps", 50)),
            compression=args.get("compression", "none")),
        log_every=int(args.get("log-every", 10)),
    )
    data = markov_stream(cfg.vocab_size, tcfg.seq_len, tcfg.global_batch,
                         seed=tcfg.seed)

    if "carbon-target" in args:
        from repro_torch.carbon.intensity import TraceProvider
        from repro_torch.cluster.slices import tpu_v5e_family
        from repro_torch.core.carbon_aware_trainer import (
            CarbonAwareTrainer, slice_device_lists)
        from repro_torch.core.elastic import ElasticJob
        family = tpu_v5e_family()
        slice_devs = slice_device_lists(family, device)
        with tempfile.TemporaryDirectory(prefix="lxcc_") as tmp:
            job = ElasticJob(model, tcfg, args.get("ckpt-dir", tmp))
            job.start(slice_devs[family.baseline_idx])
            ccfg = CarbonConfig(target_rate=float(args["carbon-target"]),
                                policy=args.get("policy", "energy"),
                                region=args.get("region", "NL"))
            step_flops = (6.0 * model.param_count() * tcfg.seq_len
                          * tcfg.global_batch)
            trainer = CarbonAwareTrainer(
                job=job, family=family, slice_devices=slice_devs,
                carbon=TraceProvider.for_region(ccfg.region),
                cfg=ccfg, step_flops=step_flops,
                step_tokens=tcfg.seq_len * tcfg.global_batch,
                sim_seconds_per_step=float(args.get("sim-step-s", 60.0)))
            out = trainer.run(data, tcfg.steps)
        print(f"done: {out['steps']} steps, {len(out['migrations'])} "
              f"migrations")
        for log in out["logs"][-5:]:
            print(f"  t={log.t/3600:.1f}h slice={log.slice_name} "
                  f"duty={log.duty:.2f} C={log.carbon_rate:.0f} g/hr "
                  f"({log.action})")
        return 0

    out = TL.run(model, tcfg, data, device=device)
    print(f"final loss {out['history'][-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
