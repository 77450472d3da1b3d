"""Time `chip_smoke.py`'s sweep and serving phases in several checkouts of
this repository on one card, in turns, so that two versions of the code
those phases run are compared on the same card within one run.

    python3 src/repro_torch/launch/compare_phases.py TREE [TREE ...]
        [--phases placed_sweep,layered_sweep,serving] [--rounds 1]

Each TREE is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive`` into a git-ignored directory). The trees
take their turns in the order given and then in reverse (0, 1, 1, 0 for
two), ``--rounds`` times. Each turn runs one subprocess that imports
``TREE/chip_smoke.py`` with ``TREE/src`` first on the path, builds that
tree's kernels into ``TREE/build`` and runs, on one card, the phases
named by ``--phases`` (default all three) as `chip_smoke.py` runs them
(TF32 off):

  - ``placed_sweep``, chip_smoke's ``full_width``: the placed sweep,
    100,000 traces × 10 targets: ``sweep_s``, ``plan_s`` (wall, ended by
    a device sync);
  - ``layered_sweep``, its ``layered_full_width``: the layered sweep at
    the same size: ``sweep_s``, ``plan_s``;
  - ``serving``, its ``serving_full_width`` for each model of
    ``SERVE_FULL``: one ``ServeEngine.generate``'s ``prefill_s``,
    ``decode_s`` and tokens per second, and from torch.profiler the wall
    and device seconds of one more prefill and one decode step.

Prints one JSON line per turn, then a summary with each tree's median
over its turns and each median's ratio to the first tree's; the full
record goes to ``chiprun_out/compare_phases.json``. Needs one CUDA card
and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

CHILD = r'''
import json, sys
tree, phases = sys.argv[1], sys.argv[2].split(",")
sys.path[:0] = [tree + "/src", tree]
import torch
import chip_smoke as cs
from repro_torch import cuda_build
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda_build.build(list(cs._kernel_counters()))
out = {}
for name, phase in (("placed_sweep", cs.full_width),
                    ("layered_sweep", cs.layered_full_width)):
    if name not in phases:
        continue
    r = phase(dev)
    out[name] = {"sweep_s": r["sweep_s"], "plan_s": r["plan_s"]}
    cs._free_device_memory()
for arch, *shape in (cs.SERVE_FULL if "serving" in phases else ()):
    _, r = cs.serving_full_width(dev, arch, *shape)
    out[arch] = {k: r[k] for k in ("prefill_s", "decode_s", "prefill_tok_s",
                                   "decode_tok_s")}
    for step in ("prefill", "decode_step"):
        for k in ("wall_s", "device_s"):
            out[arch][f"{step}_{k}_profiled"] = r["profile"][step][k]
    cs._free_device_memory()
print("RESULT " + json.dumps(out), flush=True)
'''


PHASES = ("placed_sweep", "layered_sweep", "serving")


def _turn(tree: Path, phases) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tree),
                           ",".join(phases)],
                          cwd=tree, capture_output=True, text=True,
                          timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{tree}: rc {proc.returncode}\n"
                       f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases takes {', '.join(PHASES)}")
    trees = [t.resolve() for t in args.trees]
    order = (list(range(len(trees)))
             + list(reversed(range(len(trees))))) * args.rounds
    turns = []
    for i in order:
        res = _turn(trees[i], phases)
        turns.append({"tree": str(trees[i]), "index": i, "phases": res})
        print(json.dumps(turns[-1]), flush=True)
    medians = []
    for i in range(len(trees)):
        runs = [t["phases"] for t in turns if t["index"] == i]
        medians.append({ph: {k: float(np.median([r[ph][k] for r in runs]))
                             for k in runs[0][ph]} for ph in runs[0]})
    summary = {"trees": [str(t) for t in trees], "median": medians,
               "ratio_to_first": [
                   {ph: {k: m[ph][k] / medians[0][ph][k] for k in m[ph]}
                    for ph in m} for m in medians]}
    print(json.dumps(summary), flush=True)
    out = Path("chiprun_out")
    os.makedirs(out, exist_ok=True)
    (out / "compare_phases.json").write_text(json.dumps(
        {"turns": turns, **summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
