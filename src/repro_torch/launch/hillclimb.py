"""The hill-climber's variants (the reference's
`src/repro/launch/hillclimb.py`) on abstract meshes: each variant is one
cell of the dry run at the published widths under one lever (a rules
override, a mesh shape, a microbatch, a remat policy or config fields),
run as one device of its mesh (`dryrun_lib.analyze_cell` with an
abstract mesh, `launch.mesh.make_abstract_mesh`).

The reference reads a variant's per-device memory and collective wire
bytes from its compiled artifact, and with ``probes`` adds the FLOPs of
the marginal-layer probes (twice: XLA's plain attention and the chunked
one). The port has no compiled artifact: its wire bytes always come from
the probes, one device's steps with `launch.collectives.COUNTER` on, and
``probes=True`` adds their FLOP and byte counts. There is no
``cost_probed_flash`` twin: the probe already runs the flash kernel.
Per-device argument bytes are arithmetic over the shardings (the
reference's ``argument_bytes``), and ``memory["probe_peak_bytes"]`` the
card's measured peak over the probes. A variant whose per-device bytes
exceed the card says so and is not run.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--only A1,B1]
      [--smoke true --device cpu]   # a rehearsal at the smoke configs

JSONs go to ``build/hillclimb/<arch>__<shape>__<variant>.json``
(git-ignored). Importing this module sets no environment variable and
touches no device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import traceback

from repro_torch.config import parse_cli
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun_lib as DL
from repro_torch.launch.mesh import make_abstract_mesh, make_production_mesh
from repro_torch.launch.roofline import axis_seconds

OUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                   "..", "build", "hillclimb"))

PURE_DP = {"tp": (), "fsdp": (), "sp": (), "expert": (), "kv_seq": (),
           "batch": ("pod", "data", "model")}
SERVE_TP = {"fsdp": ()}

# how `main` runs the variants (the lambdas pass the reference's arguments
# only): the published or the smoke configs, the device, the JSONs' folder
_RUN = {"smoke": False, "device": "cuda", "out_dir": OUT}


def run_variant(name, arch, shape, *, cfg_kw=None, rules_override=None,
                microbatch=0, remat="full", probes=False, mesh_shape=None,
                smoke=None, device=None, out_dir=None):
    """One variant as one device of its mesh (`mesh_shape` None: the
    16×16 production mesh, else an abstract ("data", "model") mesh of
    that shape); the record, also written to `out_dir`. `smoke` takes
    the architecture's smoke config instead of the published one (a
    rehearsal; `shape` may then be a `ShapeConfig` of its own). `smoke`,
    `device` and `out_dir` default to `main`'s (published, "cuda",
    ``build/hillclimb``)."""
    smoke = _RUN["smoke"] if smoke is None else smoke
    device = _RUN["device"] if device is None else device
    out_dir = _RUN["out_dir"] if out_dir is None else out_dir
    if mesh_shape is None:
        mesh = make_production_mesh(device=device)
    else:
        mesh = make_abstract_mesh(mesh_shape, ("data", "model"), device)
    spec = get_arch(arch)
    cfg = spec.smoke if smoke else spec.full
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    res = DL.analyze_cell(arch, shape, device, cfg=cfg, remat=remat,
                          microbatch=microbatch, probes=probes, mesh=mesh,
                          rules_override=rules_override)
    res.update({"variant": name,
                "cfg_kw": {k: str(v) for k, v in (cfg_kw or {}).items()},
                "rules_override": {k: list(v) for k, v in
                                  (rules_override or {}).items()}})
    if "collectives" in res:
        res["collective_s"] = axis_seconds(res["collectives"]["per_axis"])
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{res['shape']}__{name}.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    mem = res["memory"]
    line = f"  [{name}] args {mem['argument_bytes']/1e9:7.3f} GB/dev"
    if "collectives" in res:
        wire = res["collectives"]["total_wire_bytes"]
        line = (f"  [{name}] wire {wire/1e9:8.3f} GB/dev -> "
                f"{res['collective_s']:7.4f} s  args "
                f"{mem['argument_bytes']/1e9:7.3f} GB/dev")
        if mem.get("probe_peak_bytes") is not None:
            line += f"  probe peak {mem['probe_peak_bytes']/1e9:6.2f} GB"
    if "probe" in res:
        line += f"  ({res['probe']})"
    print(line, flush=True)
    return res


VARIANTS = {
    # --- Cell A: chameleon-34b train_4k (most collective-bound) ----------
    "A1": lambda: run_variant("A1_bf16_gather", "chameleon-34b",
                                   "train_4k"),
    "A0": lambda: run_variant("A0_f32_gather", "chameleon-34b",
                                   "train_4k",
                                   cfg_kw={"cast_weights": False}),
    "A2": lambda: run_variant("A2_bf16_microbatch128", "chameleon-34b",
                                   "train_4k", microbatch=128),
    "A3": lambda: run_variant("A3_bf16_mb64", "chameleon-34b",
                                   "train_4k", microbatch=64),
    "A4": lambda: run_variant("A4_no_sp", "chameleon-34b", "train_4k",
                                   cfg_kw={"seq_shard": False}),
    "A6": lambda: run_variant("A6_mesh64x4", "chameleon-34b",
                                   "train_4k", mesh_shape=(64, 4),
                                   microbatch=128),
    "A7": lambda: run_variant("A7_mesh64x4_final", "chameleon-34b",
                                   "train_4k", mesh_shape=(64, 4),
                                   microbatch=128, probes=True),
    "A8": lambda: run_variant("A8_mesh128x2", "chameleon-34b",
                                   "train_4k", mesh_shape=(128, 2),
                                   microbatch=128),
    "A9": lambda: run_variant("A9_mesh256x1_fsdp", "chameleon-34b",
                                   "train_4k", mesh_shape=(256, 1)),
    "A10": lambda: run_variant("A10_fsdp_final", "chameleon-34b",
                                    "train_4k", mesh_shape=(256, 1),
                                    probes=True),
    "B3": lambda: run_variant("B3_pure_dp_final", "smollm-135m",
                                   "train_4k", rules_override=PURE_DP,
                                   remat="none", probes=True),
    "A2F": lambda: run_variant("A2F_final_probe", "chameleon-34b",
                                    "train_4k", microbatch=128,
                                    probes=True),
    "A5": lambda: run_variant("A5_no_sp_mb128", "chameleon-34b",
                                   "train_4k", cfg_kw={"seq_shard": False},
                                   microbatch=128),
    # --- Cell B: smollm-135m train_4k (worst roofline fraction) ----------
    "B0": lambda: run_variant("B0_baseline_sharded", "smollm-135m",
                                   "train_4k",
                                   cfg_kw={"cast_weights": False}),
    "B1": lambda: run_variant("B1_pure_dp", "smollm-135m", "train_4k",
                                   rules_override=PURE_DP, probes=True),
    "B2": lambda: run_variant("B2_pure_dp_nomat", "smollm-135m",
                                   "train_4k", rules_override=PURE_DP,
                                   remat="none", probes=True),
    "D1": lambda: run_variant("D1_dbrx_mb64", "dbrx-132b", "train_4k",
                                   microbatch=64),
    "D2": lambda: run_variant("D2_dbrx_fsdp_ep", "dbrx-132b",
                                   "train_4k", mesh_shape=(16, 16),
                                   microbatch=32),
    "D3": lambda: run_variant("D3_dbrx_mb16", "dbrx-132b", "train_4k",
                                   microbatch=16),
    # --- Cell C: starcoder2-15b decode_32k (serving; paper-representative)
    "C0": lambda: run_variant("C0_fsdp_f32", "starcoder2-15b",
                                   "decode_32k",
                                   cfg_kw={"cast_weights": False}),
    "C1": lambda: run_variant("C1_fsdp_bf16", "starcoder2-15b",
                                   "decode_32k"),
    "C2": lambda: run_variant("C2_pure_tp", "starcoder2-15b",
                                   "decode_32k", rules_override=SERVE_TP,
                                   cfg_kw={"param_dtype": "bfloat16"},
                                   probes=True),
}


def main(argv=None) -> int:
    """Run the variants (``--only A1,B1``: those); one line each. A
    variant that raises prints FAIL and the rest run; the exit code is
    then 1."""
    args = parse_cli(argv if argv is not None else sys.argv[1:])
    only = args["only"].split(",") if "only" in args else None
    if only and set(only) - set(VARIANTS):
        print(f"unknown variants: {sorted(set(only) - set(VARIANTS))}")
        return 2
    before = dict(_RUN)
    _RUN.update(smoke=args.get("smoke", "false").lower() != "false",
                device=args.get("device", "cuda"),
                out_dir=os.path.abspath(args.get("out-dir", OUT)))
    failures = []
    try:
        for key, fn in VARIANTS.items():
            if only and key not in only:
                continue
            print(f"=== {key} ===", flush=True)
            try:
                fn()
            except Exception as e:      # a variant's failure; the rest run
                traceback.print_exc()
                failures.append(key)
                print(f"  FAIL {e!r}", flush=True)
    finally:
        _RUN.clear()
        _RUN.update(before)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
