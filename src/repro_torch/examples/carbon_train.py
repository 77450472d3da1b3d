"""End-to-end Carbon Containers demo (the reference's
`examples/carbon_train.py`): train a small model for a few hundred steps
under a carbon cap with live enforcement (duty-cycling, migration
between slices as a real checkpoint -> restore, suspend/resume) while
the grid's carbon intensity follows a diurnal trace.

    PYTHONPATH=src python -m repro_torch.examples.carbon_train
        [--steps 200] [--device cpu]

The reference fakes 8 CPU devices to get slices of 1, 2, 4 and 8 chips.
Here the same four slices (power ∝ chips) are virtual slices over the
one device (`slice_device_lists` without a process group): each
migration checkpoints the job and restores it onto that device.
"""
import sys
import tempfile

from repro_torch.carbon.intensity import TraceProvider
from repro_torch.cluster.slices import Slice, SliceFamily
from repro_torch.config import (CarbonConfig, OptimizerConfig, TrainConfig,
                                parse_cli)
from repro_torch.configs import get_arch
from repro_torch.core.carbon_aware_trainer import (CarbonAwareTrainer,
                                                   slice_device_lists)
from repro_torch.core.elastic import ElasticJob
from repro_torch.data.pipeline import markov_stream
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.power.model import LinearPowerModel


def demo_family(device) -> tuple:
    """Slice family of 1/2/4/8 chips, power ∝ chips, and each slice's
    devices (`slice_device_lists`)."""
    sizes = [1, 2, 4, 8]
    slices = [Slice(f"dev-{s}", s / sizes[len(sizes) // 2],
                    LinearPowerModel(40.0 * s, 110.0 * s), chips=s)
              for s in sizes]
    fam = SliceFamily(slices, baseline_idx=len(sizes) // 2)
    return fam, slice_device_lists(fam, device)


def main(argv=None) -> dict:
    args = parse_cli(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.get("device", "cuda"))
    steps = int(args.get("steps", 200))

    spec = get_arch("smollm-135m")
    model = get_model(spec.smoke)
    tcfg = TrainConfig(seq_len=64, global_batch=8, steps=steps,
                       optimizer=OptimizerConfig(lr=2e-3, warmup_steps=10,
                                                 total_steps=steps),
                       log_every=0)
    fam, slice_devs = demo_family(device)
    ccfg = CarbonConfig(target_rate=45.0, policy="energy", region="NL",
                        interval_s=300.0)
    # each train step advances the sim clock by 90 s -> 200 steps ≈ 5 h of
    # grid variation; demand varies with the duty cycle the policy sets
    step_flops = 6.0 * model.param_count() * tcfg.seq_len * tcfg.global_batch
    data = markov_stream(spec.smoke.vocab_size, tcfg.seq_len,
                         tcfg.global_batch, temperature=0.2)
    with tempfile.TemporaryDirectory(prefix="lxcc_") as ckpt:
        job = ElasticJob(model, tcfg, ckpt)
        job.start(slice_devs[fam.baseline_idx])
        # the virtual slices' peak: ~60 s a step at MFU = 1
        trainer = CarbonAwareTrainer(
            job=job, family=fam, slice_devices=slice_devs,
            carbon=TraceProvider.for_region(ccfg.region, seed=4),
            cfg=ccfg, step_flops=step_flops,
            step_tokens=tcfg.seq_len * tcfg.global_batch,
            peak_flops_per_chip=step_flops / 60.0,
            sim_seconds_per_step=90.0)
        print(f"target C = {ccfg.target_rate} g/hr, region {ccfg.region}, "
              f"policy {ccfg.policy}")
        out = trainer.run(data, steps)
    print(f"\ncompleted {out['steps']} steps with "
          f"{len(out['migrations'])} live migrations")
    print("timeline (one row per monitoring interval):")
    for log in out["logs"][:: max(1, len(out["logs"]) // 12)]:
        bar = "#" * int(log.carbon_rate / 3)
        print(f"  t={log.t/3600:5.2f}h  c={log.carbon_intensity:4.0f} g/kWh  "
              f"slice={log.slice_name:6s} duty={log.duty:4.2f} "
              f"C={log.carbon_rate:6.1f} g/hr {bar}")
    rates = [x.carbon_rate for x in out["logs"]]
    avg = sum(rates) / len(rates)
    enforced = avg <= ccfg.target_rate
    print(f"\navg C(t) = {avg:.1f} g/hr (target {ccfg.target_rate}) — "
          f"{'ENFORCED' if enforced else 'EXCEEDED'}")
    return {"steps": out["steps"], "migrations": len(out["migrations"]),
            "avg_rate_g_per_h": avg, "target_g_per_h": ccfg.target_rate,
            "enforced": enforced,
            "logs": [(x.t, x.carbon_intensity, x.slice_name, x.duty,
                      x.suspended, x.action, x.carbon_rate)
                     for x in out["logs"]]}


if __name__ == "__main__":
    main()
