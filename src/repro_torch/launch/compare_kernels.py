"""Time the flash-attention and SSD kernels of several checkouts of this
repository on one card, in turns, so that two versions are compared on
the same card within one run.

    python3 src/repro_torch/launch/compare_kernels.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive`` into a git-ignored directory). The trees
take their turns in the order given and then in reverse (0, 1, 1, 0 for
two). Each turn runs one subprocess with ``TREE/src`` first on the path,
which builds that tree's kernels into ``TREE/build`` and times them with
CUDA events (median of 50 launches, each behind a spin kernel so the
events time the device work alone) on the same seeded inputs:

  - flash_attention at (4, 2048, 24:8, 128) causal, bf16 (phi4-mini's
    prefill) and (4, 2048, 16:1, 256) causal, window 2048, bf16
    (RecurrentGemma's);
  - ssd_scan at (4, 2048, H 80, P 64, N 128, chunk 256), bf16 (Mamba-2's),
    with x, b and c as the contiguous tensors every version accepts.

Prints one JSON line per turn, then a summary with each tree's median
over its turns and the speed-up of each tree over the first; the full
record goes to ``chiprun_out/compare_kernels.json``. Needs one CUDA card
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
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import torch.nn.functional as F
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
dev = torch.device("cuda", 0)

def median_ms(fn):
    for _ in range(5):
        fn()
    times = []
    for _ in range(50):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))

out = {}
for name, (B, S, Hq, Hkv, Dh, window) in {
        "flash_phi4": (4, 2048, 24, 8, 128, 0),
        "flash_rg": (4, 2048, 16, 1, 256, 2048)}.items():
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, S, h, Dh, generator=gen, device=dev).bfloat16()
               for h in (Hq, Hkv, Hkv))
    out[name] = median_ms(lambda: flash_attention(q, k, v, causal=True,
                                                  window=window))
B, S, H, P, N, Q = 4, 2048, 80, 64, 128, 256
gen = torch.Generator(device=dev).manual_seed(0)
f = lambda *s: torch.randn(*s, generator=gen, device=dev)
args = (f(B, S, H, P).bfloat16(), F.softplus(f(B, S, H)),
        torch.rand(H, generator=gen, device=dev) * 1.5,
        f(B, S, 1, N).bfloat16(), f(B, S, 1, N).bfloat16(),
        torch.ones(H, device=dev))
out["ssd_mamba2"] = median_ms(lambda: ssd_scan(*args, chunk=Q))
print(json.dumps(out))
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: CUDA is not available")
    trees = [t.resolve() for t in args.trees]
    order = list(range(len(trees))) + list(range(len(trees)))[::-1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    turns = []
    for i in order:
        res = subprocess.run(
            [sys.executable, "-c", CHILD, str(trees[i] / "src")],
            cwd=trees[i], capture_output=True, text=True, timeout=1200,
            env={**os.environ, "PYTHONPATH": ""})
        if res.returncode:
            raise SystemExit(f"turn of {trees[i]} failed:\n{res.stderr[-4000:]}")
        times = json.loads(res.stdout.strip().splitlines()[-1])
        turns.append({"tree": str(args.trees[i]), "index": i, **times})
        print(json.dumps(turns[-1]), flush=True)
    keys = [k for k in turns[0] if k not in ("tree", "index")]
    summary = {}
    for i, tree in enumerate(args.trees):
        mine = [t for t in turns if t["index"] == i]
        summary[str(tree)] = {k: float(np.median([t[k] for t in mine]))
                              for k in keys}
    base = summary[str(args.trees[0])]
    for tree, times in summary.items():
        times["speedup_over_first"] = {k: base[k] / times[k] for k in keys}
    record = {"card": card, "order": order, "turns": turns,
              "summary": summary}
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "compare_kernels.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"card": card, "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
