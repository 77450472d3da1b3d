"""A configuration of a new model family, on four cards, joins the
benchmark as new files only. In a copy of `BENCHMARK.json` and
`portbench/`, the family ``twin`` comes as copies of the dense family's
reference and counts, the configuration as a file with its ``small``
widths, the cell as a workload file (with the small traffic that splits
over 4 ranks, and the mesh's model axis: 1, data-parallel, or 2, the
layout an expert- or tensor-parallel cell asks for) and new entries in
the manifest; then the copy's own tests of the manifest's rules, of the
cell's files and of a small run of the cell pass against the copy, and
no file that the copy already had under `portbench/` changed."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

import portbench_cases

ROOT = portbench_cases.ROOT
FAMILY, CONFIG = "twin", "twin-135m"
CELL = f"{CONFIG}.train-4k-4chip"
LIKE = "smollm-135m.train-4k"       # the cell whose files the new one copies


def _digests(tree) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(tree.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _add_cell(root, model_axis: int):
    """The new family, configuration and cell: new files, and new entries
    in the manifest."""
    bench = root / "portbench"
    for part in ("reference", "roofline"):
        shutil.copy(bench / part / "dense.py", bench / part / f"{FAMILY}.py")
    conf = json.loads((bench / "configs" / "smollm-135m.json").read_text())
    conf["family"] = FAMILY
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(conf))
    work = json.loads((bench / "workloads" / f"{LIKE}.json").read_text())
    work["traffic"]["model_axis"] = model_axis
    work["small"] = {"traffic": {"global_batch": 16, "microbatch": 8}}
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(work))
    man = json.loads((root / "BENCHMARK.json").read_text())
    like = next(w for w in man["workloads"] if w["name"] == LIKE)
    source = next(c for c in man["configs"] if c["name"] == like["config"])
    man["configs"].append(dict(source, name=CONFIG,
                               file=f"portbench/configs/{CONFIG}.json"))
    man["workloads"].append(dict(like, name=CELL, config=CONFIG, chips=4,
                                 why="the 4k rows data-parallel over 4 cards"))
    for m in man["end_to_end"] + man["per_layer"]:
        if LIKE in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))


@pytest.mark.parametrize("model_axis", [1, 2])
def test_new_family_on_four_cards_needs_new_files_only(tmp_path, model_axis):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "portbench")
    assert before == {k: v for k, v in _digests(ROOT / "portbench").items()
                      if k in before}
    _add_cell(tmp_path, model_axis)

    tests = "portbench/tests/test_portbench_harness.py"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "--rootdir", str(tmp_path),
         f"{tests}::test_manifest_names_units_and_keys",
         f"{tests}::test_one_name_a_layer",
         f"{tests}::test_cell_files_found_by_name[{CELL}]",
         f"{tests}::test_small_run_is_correct[{CELL}]"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    assert "4 passed" in p.stdout

    after = _digests(tmp_path / "portbench")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        f"reference/{FAMILY}.py", f"roofline/{FAMILY}.py",
        f"configs/{CONFIG}.json", f"workloads/{CELL}.json"}
