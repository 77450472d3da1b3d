"""Where a cell's set-up spends its time, run after run:

    python3 portbench/setup_profile.py --workload <cell> --seeds 1,2,3 \\
        --out <file.jsonl>

Each seed runs in a process of its own, as a benchmark run does, with
its caches: the imports, the card's start and the traffic's set-up (the state from the
seed, the warm-up and check steps), under `cProfile`, then it exits
without a window. Each line of ``--out`` holds the phases' seconds and
the functions that took most time, by their own and by their
cumulative time.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import cProfile  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import pstats  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def one(cell: str, seed: int) -> dict:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench.run import use_caches
    use_caches()
    phases = {}
    t = time.perf_counter()
    import torch
    phases["import_torch"] = time.perf_counter() - t
    t = time.perf_counter()
    from portbench import harness
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    w = harness.cell(manifest, cell)
    conf = harness.load_json(harness.BENCH / "configs" / f"{w['config']}.json")
    work = harness.load_json(harness.BENCH / "workloads" / f"{cell}.json")
    kind = harness.load_module(harness.BENCH / "traffic"
                               / f"{work['traffic']['kind']}.py")
    run = harness.Run(cell, seed, torch.device("cuda"), conf, work,
                      harness.model_config(conf))
    phases["import_rest"] = time.perf_counter() - t
    t = time.perf_counter()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    phases["card_start"] = time.perf_counter() - t
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    kind.setup(run)
    torch.cuda.synchronize()
    prof.disable()
    phases["traffic_setup"] = time.perf_counter() - t
    phases["total"] = time.perf_counter() - T0
    tops = {}
    for key in ("tottime", "cumulative"):
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(30)
        tops[key] = buf.getvalue().splitlines()[-40:]
    return {"workload": cell, "seed": seed, "phases": phases, "top": tops}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    ap.add_argument("--one", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.workload, args.one)), flush=True)
        return 0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        p = subprocess.run([sys.executable, __file__, "--workload",
                            args.workload, "--seeds", "0", "--one",
                            str(seed)], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        row = (json.loads(p.stdout.strip().splitlines()[-1])
               if p.returncode == 0 else {"seed": seed, "rc": p.returncode})
        row["stderr"] = p.stderr[-3000:]
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps({"seed": seed, "phases": row.get("phases")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
