"""The readings that a cell's limits are set from, beside the program's:
its control and its planted faults, on the card at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 21,22,23 \\
        [--seconds S] --out <file.jsonl>

A training cell, for each seed: the float32 reference that the program
is held to, the same reference in emulated fp8 (the control: the step
below the configuration's bf16) and the float32 reference with half of
each batch left out (a fault: the mean taken over the rest), each over
the cell's check steps from the seeded state; each line gives the
comparison's numbers for the control and for the fault. A state left
unchanged needs no run: it reads 1 on the change.

A serving cell, for each seed: the program serves a window of
``--seconds`` at the cell's load; then the float32 reference's logits at
the served positions of the sampled requests give the program's widest
gap, the widest gap of the tokens that the fp8 reference puts first
there (the control) and of the served tokens each altered by one (a
fault); with ``--program-only``, the program's gap alone.

The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def train_readings(run, compare) -> dict:
    from portbench.reference import common as C
    from portbench.reference import drive
    t = run.traffic
    batches = [C.train_batch(run.seed, i, t["global_batch"], t["seq"],
                             run.m["vocab_size"], run.device)
               for i in range(t["check_steps"])]
    follow = lambda **kw: drive.follow_train(  # noqa: E731
        run.family, run.m, run.seed, batches, t["optimizer"],
        rows=t["reference_rows"], device=run.device, **kw)
    ref = follow()
    out = {"reference_loss": ref["loss"]}
    for name, kw in (("control_fp8", {"precision": "fp8"}),
                     ("half_batch", {"keep_rows": t["global_batch"] // 2})):
        got = follow(**kw)
        out[name] = {n: v for n, v, _ in compare(got, ref, run.work["limits"])}
    return out


def serve_readings(run, driver, seconds: float,
                   program_only: bool = False) -> dict:
    import torch
    from portbench.reference import common as C
    from portbench.reference import drive
    driver.window(seconds)
    driver.release()
    rows, chosen = driver.sample()
    params = C.init_params(driver.layout, run.seed, run.device)
    ref = drive.served_logits(run.family, run.m, params, rows, driver.n_new)
    if program_only:
        return {"requests": int(rows.shape[0]),
                "program": {"logit_gap": drive.widest_gap(ref, chosen)}}
    ctl = drive.served_logits(run.family, run.m, params, rows, driver.n_new,
                              precision="fp8")
    altered = (chosen + 1) % run.m["vocab_size"]
    del params
    torch.cuda.empty_cache()
    return {"requests": int(rows.shape[0]),
            "program": {"logit_gap": drive.widest_gap(ref, chosen)},
            "control_fp8": {"logit_gap": drive.widest_gap(
                ref, ctl.argmax(-1))},
            "token_altered": {"logit_gap": drive.widest_gap(ref, altered)}}


def sweep(run, driver, intervals, seconds: float) -> dict:
    """The serving cell's window at each batch interval: each batch's
    latency, from the moment it was due. Below capacity they stay level;
    above it the backlog, and so the latency, grows batch by batch."""
    out = {}
    for interval in intervals:
        driver.run.work["traffic"]["interval_s"] = interval
        driver.window(seconds)
        lat = driver.batch_latency
        out[str(interval)] = {"batches": len(lat), "latency_s": lat,
                              "growth_s": lat[-1] - lat[0]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--intervals",
                    help="serving: a sweep of batch intervals (s), for the "
                         "capacity, in place of the readings")
    ap.add_argument("--program-only", action="store_true",
                    help="serving: the program's widest gap alone, without "
                         "the control and the fault")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    w = harness.cell(manifest, args.workload)
    conf = harness.load_json(harness.BENCH / "configs" / f"{w['config']}.json")
    work = harness.load_json(harness.BENCH / "workloads"
                             / f"{args.workload}.json")
    kind = harness.load_module(harness.BENCH / "traffic"
                               / f"{work['traffic']['kind']}.py")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        run = harness.Run(args.workload, seed, torch.device("cuda"), conf,
                          work, harness.model_config(conf))
        if args.intervals:
            row = {"sweep": sweep(run, kind.setup(run), [
                float(x) for x in args.intervals.split(",")], args.seconds)}
        elif hasattr(kind, "compare"):
            row = train_readings(run, kind.compare)
        else:
            row = serve_readings(run, kind.setup(run), args.seconds,
                                 args.program_only)
        row.update(workload=args.workload, seed=seed,
                   wall_s=time.perf_counter() - t)
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
