"""Runs of one cell in a row, for its spread and its seeds:

    python3 portbench/repeat.py --workload <cell> --seeds 11,12,13 \\
        [--seconds S] [--trace 0|1] --out <file.jsonl>

Each run is `run.py` in a process of its own, one after another (one
process a card). Each run's line, exit code, wall time and the end of
its standard error are appended to ``--out``; then each metric's and
each compared number's values, median and spread (the quartiles'
distance over the median, by ``statistics.quantiles(n=4)``) are
printed.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=900)
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads(
        (ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    rows = []
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        cmd = [sys.executable, str(ROOT / "portbench" / "run.py"),
               "--workload", args.workload, "--seed", str(seed),
               "--seconds", str(seconds), "--trace", str(args.trace)]
        t = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=args.timeout)
        lines = p.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if p.returncode == 0 else None
        except (IndexError, json.JSONDecodeError):
            result = None
        row = {"workload": args.workload, "seed": seed, "rc": p.returncode,
               "wall_s": time.perf_counter() - t, "trace": args.trace,
               "seconds": seconds, "result": result,
               "stderr": p.stderr[-4000:]}
        rows.append(row)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps({k: row[k] for k in ("seed", "rc", "wall_s")}
                         | {"correct": (result or {}).get("correct")}),
              flush=True)
    ok = [r["result"] for r in rows if r["result"]]
    for key in ("metrics", "compared"):
        names = sorted({n for r in ok for n in r.get(key, {})})
        for n in names:
            vals = [r[key][n]["value"] for r in ok if n in r.get(key, {})]
            line = {"what": f"{key}.{n}", "values": vals,
                    "median": statistics.median(vals)}
            if len(vals) >= 2:
                line["spread"] = spread(vals)
            print(json.dumps(line), flush=True)
    return 0 if len(ok) == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
