"""Small versions of the benchmark's cells for the CPU tests: each
configuration at the program's smoke widths, its traffic cut to a few
short rows; the program's configuration is the file's, field for
field."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402

SMOKE_MODEL = {
    "smollm-135m": {"hidden_size": 64, "num_hidden_layers": 2,
                    "num_attention_heads": 4, "num_key_value_heads": 2,
                    "head_dim": 16, "intermediate_size": 128,
                    "vocab_size": 256},
    "mamba2-2.7b": {"d_model": 64, "n_layer": 2, "vocab_size": 256,
                    "d_state": 16, "headdim": 32, "chunk_size": 16},
}
# serving at a model width whose logits spread as the published ones do
# (an altered token then reads as far below the best as at full size)
CELL_MODEL = {"mamba2-2.7b.serve-longdoc": {"d_model": 512}}
SMALL_TRAFFIC = {
    "train_steps": {"seq": 32, "global_batch": 4, "microbatch": 2,
                    "reference_rows": 2, "trace_steps": 1},
    "serve_open_loop": {"batch": 2, "prompt": 32, "interval_s": 0.02,
                        "trace_batches": 2, "check_requests": 3},
}
SEED = 2**33 + 7            # more than 32 bits, as the driver's seeds are


def manifest() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def small(cell: str, dtype: str = "float32") -> dict:
    """run_cell's keyword arguments for `cell` at the small size, in
    `dtype` (float32: the program and the reference agree to rounding)."""
    from repro_torch.configs.registry import get_arch
    w = harness.cell(manifest(), cell)
    conf = harness.load_json(harness.BENCH / "configs"
                             / f"{w['config']}.json")
    conf["model"].update(SMOKE_MODEL[w["config"]], **CELL_MODEL.get(cell, {}))
    work = harness.load_json(harness.BENCH / "workloads" / f"{cell}.json")
    work["traffic"].update(SMALL_TRAFFIC[work["traffic"]["kind"]])
    cfg = dataclasses.replace(
        get_arch(conf["registry"]).full, dtype=dtype,
        **{f: conf["model"][k] for k, f in conf["port_fields"].items()})
    return {"conf": conf, "work": work, "model_cfg": cfg}


def run_small(cell: str, trace: bool = False, seconds: float = 0.2,
              dtype: str = "float32") -> dict:
    return harness.run_cell(manifest(), cell, SEED, seconds, trace, "cpu",
                            log=lambda *a, **k: None, **small(cell, dtype))
