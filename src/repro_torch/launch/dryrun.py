"""Dry run: every (architecture × input shape) cell's memory, model
FLOPs and probed FLOPs, bytes and wire bytes, on one card or as one
device of the reference's production meshes, one JSON per cell.

The reference's `src/repro/launch/dryrun.py` compiles each cell for a
256/512-chip TPU mesh; here each cell is measured on the card by
`dryrun_lib.analyze_cell` (see there). ``--mesh card`` (the default)
runs each cell whole on one card (JSONs under ``single_card/``);
``single`` and ``multi`` run it as one device of the abstract 16×16 and
2×16×16 meshes (`launch.mesh.make_production_mesh`: per-device argument
bytes, and the probes' per-device wire bytes by kind and by axis; JSONs
under ``single_pod/`` and ``multi_pod/``, as the reference's `_save`
names them); ``both`` runs single then multi. As in the reference, the
multi-pod pass records memory and wire bytes only: its probes count the
collectives and the kernels' calls, not FLOPs or bytes (the pod axis is
pure data parallel, so the per-device FLOPs are the single pod's at half
the rows). The 40 cells are `configs.registry.all_cells()`: 32 run, and
the 8 ``long_500k`` cells of the full-attention architectures are
skipped with the reference's reasons.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-2.7b \
      --shape long_500k [--remat full] [--device cuda]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke true \
      --device cpu           # the smoke configs, a rehearsal on the CPU
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \
      --arch chameleon-34b --shape train_4k    # one device of 16x16

``--skip-existing true`` keeps the JSONs already written; ``--probes
false`` records memory and model FLOPs only (on a mesh: and the wire
bytes, which always come from the probes). JSONs go to ``--save-dir``
(default ``build/dryrun``, git-ignored).
"""
from __future__ import annotations

import os
import sys
import traceback

from repro_torch.config import SHAPES, parse_cli
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.registry import all_cells
from repro_torch.launch import dryrun_lib as DL
from repro_torch.launch.mesh import make_production_mesh

MESHES = {"card": [None], "single": [False], "multi": [True],
          "both": [False, True]}

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
    meshes = MESHES[args.get("mesh", "card")]

    if "all" in args:
        cells = [(a, s) for a, s, _ in all_cells()]
    else:
        archs = [args["arch"]] if "arch" in args else list_archs()
        shapes = [args["shape"]] if "shape" in args else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]

    failures = []
    for multi_pod in meshes:
        mesh = (None if multi_pod is None else
                make_production_mesh(multi_pod=multi_pod, device=device))
        where = "single_card" if mesh is None else DL.mesh_dir(mesh)
        for arch_id, shape_name in cells:
            label = f"{arch_id} x {shape_name} ({where})"
            path = DL.cell_path(save_dir, arch_id, shape_name, where)
            if skip_existing and os.path.exists(path):
                print(f"[skip existing] {label}", flush=True)
                continue
            print(f"=== {label} ===", flush=True)
            spec = get_arch(arch_id)
            cfg = spec.smoke if smoke else spec.full
            try:
                res = DL.analyze_cell(arch_id, shape_name, device, cfg=cfg,
                                      remat=remat, probes=probes and not
                                      multi_pod, save_dir=save_dir,
                                      mesh=mesh)
            except Exception as e:  # a cell's failure is recorded; the rest run
                traceback.print_exc()
                failures.append((label, repr(e)))
                print(f"  FAIL: {e!r}", flush=True)
                continue
            if res["status"] != "ok":
                print(f"  skipped: {res['reason']}", flush=True)
                continue
            print(_line(res), flush=True)

    print(f"\n{len(failures)} failures")
    for label, err in failures:
        print(f"  {label}: {err}")
    return 1 if failures else 0


def _line(res: dict) -> str:
    mem = res["memory"]
    probed = res.get("cost_probed")
    if "mesh" in res:
        line = (f"  ok: {res['params']:,} params, arguments "
                f"{mem['argument_bytes']/1e9:.3f} GB a device "
                f"({mem['cards_needed']} card(s))")
        if "collectives" in res:
            line += (f", wire {res['collectives']['total_wire_bytes']/1e9:.3f}"
                     f" GB a device")
        if mem.get("probe_peak_bytes") is not None:
            line += f", probe peak {mem['probe_peak_bytes']/1e9:.2f} GB"
    else:
        line = (f"  ok: {res['params']:,} params, peak "
                f"{mem['peak_bytes']/1e9:.2f} GB ({mem['cards_needed']} "
                f"card(s))")
    line += f", model FLOPs {res['model_flops_global']:.4g}"
    if probed is not None:
        line += (f", probed {probed['flops']:.4g} FLOP, "
                 f"{probed['bytes_accessed']:.4g} B")
    elif "probe" in res:
        line += f", probe: {res['probe']}"
    return line


if __name__ == "__main__":
    sys.exit(main())
