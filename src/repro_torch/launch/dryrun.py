"""Single-card dry run: every (architecture × input shape) cell's memory,
model FLOPs and probed FLOPs and bytes on one card, one JSON per cell.

The reference's `src/repro/launch/dryrun.py` compiles each cell for a
256/512-chip TPU mesh; here each cell is measured on the card by
`dryrun_lib.analyze_cell` (see there). The 40 cells are
`configs.registry.all_cells()`: 32 run, and the 8 ``long_500k`` cells
of the full-attention architectures are skipped with the reference's
reasons.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-2.7b \
      --shape long_500k [--remat full] [--device cuda]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke true \
      --device cpu           # the smoke configs, a rehearsal on the CPU

``--skip-existing true`` keeps the JSONs already written; ``--probes
false`` records memory and model FLOPs only. JSONs go to ``--save-dir``
(default ``build/dryrun``, git-ignored) under ``single_card/``.
"""
from __future__ import annotations

import os
import sys
import traceback

from repro_torch.config import SHAPES, parse_cli
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.registry import all_cells
from repro_torch.launch import dryrun_lib as DL

DEFAULT_SAVE = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")


def main(argv=None) -> int:
    args = parse_cli(argv if argv is not None else sys.argv[1:])
    save_dir = os.path.abspath(args.get("save-dir", DEFAULT_SAVE))
    skip_existing = args.get("skip-existing", "false").lower() != "false"
    probes = args.get("probes", "true").lower() != "false"
    smoke = args.get("smoke", "false").lower() != "false"
    remat = args.get("remat", "full")
    device = args.get("device", "cuda")

    if "all" in args:
        cells = [(a, s) for a, s, _ in all_cells()]
    else:
        archs = [args["arch"]] if "arch" in args else list_archs()
        shapes = [args["shape"]] if "shape" in args else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]

    failures = []
    for arch_id, shape_name in cells:
        path = DL.cell_path(save_dir, arch_id, shape_name)
        if skip_existing and os.path.exists(path):
            print(f"[skip existing] {arch_id} x {shape_name}", flush=True)
            continue
        print(f"=== {arch_id} x {shape_name} ===", flush=True)
        spec = get_arch(arch_id)
        cfg = spec.smoke if smoke else spec.full
        try:
            res = DL.analyze_cell(arch_id, shape_name, device, cfg=cfg,
                                  remat=remat, probes=probes,
                                  save_dir=save_dir)
        except Exception as e:      # a cell's failure is recorded; the rest run
            traceback.print_exc()
            failures.append((f"{arch_id} x {shape_name}", repr(e)))
            print(f"  FAIL: {e!r}", flush=True)
            continue
        if res["status"] != "ok":
            print(f"  skipped: {res['reason']}", flush=True)
            continue
        mem = res["memory"]
        probed = res.get("cost_probed")
        line = (f"  ok: {res['params']:,} params, peak {mem['peak_bytes']/1e9:.2f}"
                f" GB ({mem['cards_needed']} card(s)), model FLOPs "
                f"{res['model_flops_global']:.4g}")
        if probed is not None:
            line += (f", probed {probed['flops']:.4g} FLOP, "
                     f"{probed['bytes_accessed']:.4g} B")
        elif "probe" in res:
            line += f", probe: {res['probe']}"
        print(line, flush=True)

    print(f"\n{len(failures)} failures")
    for label, err in failures:
        print(f"  {label}: {err}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
