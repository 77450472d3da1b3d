"""Rules of the port: it never imports JAX or the reference package, and
its entry points never fall back to the CPU on their own."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "src/repro_torch/core/fleet.py" in names
    assert "chip_smoke.py" in names
    assert (PORT / "csrc" / "admission_round.cu").exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_reference(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_rule_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy\nfrom repro.core import fleet\n"
                 "import jax.numpy as jnp\nfrom repro_torch import device\n")
    assert [m for _, m in _imported_roots(f) if m in FORBIDDEN] == [
        "repro", "jax"]


def test_sweep_without_device_raises_when_cuda_is_missing(monkeypatch):
    from repro_torch.carbon.intensity import ConstantProvider
    from repro_torch.cluster.slices import paper_family
    from repro_torch.core.fleet import sweep_population_torch
    from repro_torch.core.policy import CarbonAgnosticPolicy
    from repro_torch.core.simulator import SimConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ({"a": CarbonAgnosticPolicy}, paper_family(), np.ones((4, 2)),
            ConstantProvider(100.0), [45.0], SimConfig(target_rate=0.0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep_population_torch(*args)
    rows = sweep_population_torch(*args, device="cpu")
    assert len(rows) == 1
