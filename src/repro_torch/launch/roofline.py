"""Roofline of the dry run (`repro_torch.launch.dryrun`'s JSONs), the
reference's `src/repro/launch/roofline.py` on H100s.

Terms per (arch × shape) cell, in seconds a step on one card (one
device of the mesh for a mesh's cells):

  compute_s    = probed FLOPs ÷ 989 TFLOP/s (dense bf16; the marginal-
                 layer probes count every layer, and the hand kernels'
                 work through `kernels.cost`)
  memory_s     = probed bytes ÷ 3.35 TB/s (HBM)
  collective_s = Σ over the mesh axes of the axis's wire bytes per
                 device ÷ the bandwidth of the link its groups cross
                 (`axis_seconds`): NVLink 4, 450 GB/s a direction, for a
                 group inside one host of 8 cards; 50 GB/s for a group
                 that spans hosts (one 400 Gb/s NDR InfiniBand port a
                 card, NVIDIA's DGX H100 data sheet). Both are data-sheet
                 figures, not measurements: a 16-wide ring over 8-card
                 hosts is bounded by the inter-host link. Records without
                 an axis go over NVLink (`collective_seconds`, its meaning
                 unchanged); the single-card cells (``devices`` = 1)
                 exchange nothing, 0.0

with MODEL_FLOPS = 6·N·D (train) / 2·N·D (serve), N the active
parameters; the useful ratio MODEL_FLOPS / probed FLOPs; the dominant
term; the roofline fraction (MODEL_FLOPS at peak over the larger term);
the peak bytes of the cell's arguments against the card's memory, and
``cards_needed``. A sharded step's wire bytes come from
`repro_torch.launch.collectives.COUNTER` (``res["collectives"]``). Given
a step time measured on the card
(`chip_smoke.py` passes SmolLM-135M's at ``train_4k``), `roofline_row`
also carries ``step_time_s`` and ``mfu`` = the train model FLOPs
(`dryrun_lib.train_model_flops`) / (``step_time_s`` × peak).

The reference re-probes bytes without the (Sq, Skv) logits of XLA's
plain attention (`probe_bytes.py`); here the probe already runs the
flash kernel and counts its q + k + v + o (+ lse) bytes, so there is no
second pass.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--save-dir D]
      [--mesh card|single|multi] [--csv out.csv]
"""
from __future__ import annotations

import json
import os
import sys
from typing import Optional

from repro_torch.config import parse_cli
from repro_torch.configs.registry import all_cells
from repro_torch.launch.dryrun import DEFAULT_SAVE
from repro_torch.launch.dryrun_lib import HW, cell_path

# NVLink 4 on the H100 SXM: 18 links, 900 GB/s per card in both
# directions together (NVIDIA's data sheet), so 450 GB/s each way. A ring
# collective's wire bytes per device leave the card one way.
NVLINK_BW = 450e9
# between hosts: one 400 Gb/s NDR InfiniBand port per card (DGX H100 data
# sheet: eight ConnectX-7 ports for eight cards), 50 GB/s each way
INTER_HOST_BW = 50e9
CARDS_PER_HOST = 8


def link_bandwidth(n: int, stride: int) -> float:
    """The per-direction bandwidth of a group of `n` devices `stride`
    ranks apart in row-major rank order, hosts of `CARDS_PER_HOST`
    consecutive ranks: NVLink when the group's aligned block of n·stride
    ranks lies inside one host, else the inter-host link."""
    span = n * max(stride, 1)
    if span <= CARDS_PER_HOST and CARDS_PER_HOST % span == 0:
        return NVLINK_BW
    return INTER_HOST_BW


def axis_seconds(per_axis: dict) -> float:
    """Σ wire bytes ÷ `link_bandwidth` over a summary's ``per_axis``
    rows (`collectives.CollectiveCounter.summary`); a row of group size
    ≤ 1 costs nothing."""
    return sum(row["wire_bytes"] / link_bandwidth(row["n"], row["stride"])
               for row in per_axis.values() if row.get("n", 2) > 1)


def collective_seconds(wire_bytes_per_device: float, devices: int) -> float:
    """The roofline's collective term: a step's wire bytes per device
    (`collectives.CollectiveCounter.summary`) over NVLink's bandwidth per
    direction; 0.0 on one device."""
    if devices <= 1:
        return 0.0
    return wire_bytes_per_device / NVLINK_BW


NOTES = {
    "compute": "compute-bound: fewer redundant FLOPs (remat policy) or "
               "more of them on the tensor cores (the plain float32 "
               "backwards) moves it",
    "memory": "HBM-bound: fewer bytes a step (fused elementwise passes, "
              "bf16 copies) or more reuse per byte",
    "collective": "link-bound: fewer bytes on the wire a step (another "
                  "mesh shape, or bf16 gradients)",
}


def load_cells(save_dir: str, where: str = "single_card") -> list:
    """The cells' JSONs under `save_dir`/`where` (``single_card``,
    ``single_pod``, ``multi_pod``), in `all_cells` order."""
    rows = []
    for arch, shape, _ in all_cells():
        path = cell_path(save_dir, arch, shape, where)
        if os.path.exists(path):
            with open(path) as f:
                rows.append(json.load(f))
    return rows


def roofline_row(res: dict, step_time_s: Optional[float] = None) -> dict:
    if res.get("status") != "ok":
        return {"arch": res["arch"], "shape": res["shape"],
                "status": res.get("reason", res.get("status"))}
    mem = res["memory"]
    peak = mem.get("peak_bytes", mem.get("argument_bytes"))
    row = {"arch": res["arch"], "shape": res["shape"], "status": "ok",
           "devices": res["devices"],
           "model_flops_global": res["model_flops_global"],
           "peak_hbm_gb": peak / 1e9,
           "fits_hbm": peak <= res["card_bytes"],
           "cards_needed": mem["cards_needed"]}
    probed = res.get("cost_probed")
    if probed is None:
        row["probe"] = res.get("probe", "not probed")
    else:
        compute_s = probed["flops"] / HW["peak_flops_bf16"]
        memory_s = probed["bytes_accessed"] / HW["hbm_bw"]
        coll = res.get("collectives", {})
        collective_s = (axis_seconds(coll["per_axis"]) if "per_axis" in coll
                        else collective_seconds(
                            coll.get("total_wire_bytes", 0.0),
                            res["devices"]))
        terms = {"compute": compute_s, "memory": memory_s,
                 "collective": collective_s}
        dominant = max(terms, key=terms.get)
        model_flops_dev = res["model_flops_global"] / res["devices"]
        ideal = model_flops_dev / HW["peak_flops_bf16"]
        row.update({
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant,
            "useful_ratio": model_flops_dev / max(probed["flops"], 1e-30),
            "roofline_fraction": ideal / max(terms[dominant], 1e-30),
            "note": NOTES[dominant]})
    if step_time_s is not None:
        flops = res.get("train_model_flops", res["model_flops_global"])
        row["step_time_s"] = step_time_s
        row["mfu"] = flops / (step_time_s * HW["peak_flops_bf16"])
    return row


def markdown_table(rows: list) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| useful ratio | roofline frac | GB (args) | cards | "
           "step s | mfu |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|")
    out = [hdr]
    g = lambda r, k, f: format(r[k], f) if k in r else "—"  # noqa: E731
    for r in rows:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | skipped "
                       f"| — | — | — | — | — | ({r['status'][:40]}…) |")
            continue
        dominant = (f"**{r['dominant']}**" if "dominant" in r
                    else r.get("probe", "—"))
        out.append(
            f"| {r['arch']} | {r['shape']} | {g(r, 'compute_s', '.3g')} | "
            f"{g(r, 'memory_s', '.3g')} | {g(r, 'collective_s', '.3g')} | "
            f"{dominant} | {g(r, 'useful_ratio', '.2f')} | "
            f"{g(r, 'roofline_fraction', '.2f')} | {r['peak_hbm_gb']:.1f} | "
            f"{r['cards_needed']} | {g(r, 'step_time_s', '.3f')} | "
            f"{g(r, 'mfu', '.4f')} |")
    return "\n".join(out)


def main(argv=None) -> int:
    args = parse_cli(argv if argv is not None else sys.argv[1:])
    save_dir = os.path.abspath(args.get("save-dir", DEFAULT_SAVE))
    where = {"card": "single_card", "single": "single_pod",
             "multi": "multi_pod"}[args.get("mesh", "card")]
    rows = [roofline_row(r) for r in load_cells(save_dir, where)]
    print(markdown_table(rows))
    out_json = os.path.join(save_dir, "" if where == "single_card"
                            else where, "roofline.json")
    with open(out_json, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"\nwrote {out_json} "
          f"({sum(1 for r in rows if r.get('status') == 'ok')} ok rows)")
    if "csv" in args:
        import csv
        keys = ["arch", "shape", "compute_s", "memory_s", "collective_s",
                "dominant", "useful_ratio", "roofline_fraction",
                "peak_hbm_gb", "cards_needed", "step_time_s", "mfu"]
        with open(args["csv"], "w", newline="") as f:
            w = csv.DictWriter(f, keys, extrasaction="ignore")
            w.writeheader()
            for r in rows:
                if r.get("status") == "ok":
                    w.writerow(r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
