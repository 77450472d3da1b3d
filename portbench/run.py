"""The benchmark of the PyTorch/CUDA port, one cell a run:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs a CUDA card (it exits with 2
without one, or with fewer cards than the cell asks for), builds or
loads the program's kernels under the checkout's ``build/`` (and keeps
the imported modules' bytecode in ``build/pycache``), makes the
state and the traffic from the seed on the card, warms up, measures for
``--seconds`` (with ``--trace 1``: traces a stretch of the window and
reports the per-layer metrics instead), checks the outputs against the
plain reference, and prints one JSON line last on standard output. The
numbers compared are printed, each beside its limit, as the last lines
of standard error and under ``compared`` in the result line.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the run's libraries keep, at fixed paths inside the checkout;
# the bytecode of every imported module too: where the installation keeps
# none of its own, each run would compile torch's sources anew
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "build/inductor",
          "PYTHONPYCACHEPREFIX": "build/pycache"}


def use_caches():
    """Point every cache of this process and its children into the
    checkout."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / sub)
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_caches()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from portbench import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    chips = harness.cell(manifest, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = harness.run_cell(manifest, args.workload, args.seed,
                              args.seconds, bool(args.trace), "cuda", T0)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
