"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under portbench/ (top-level names compared whole, so the port
``repro_torch`` passes), and nothing of the program at all in the plain
references."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

import portbench_cases  # noqa: F401  (puts the checkout on sys.path)
from portbench.harness import FORBIDDEN as NAMES

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = set(NAMES)


def imported(path: Path) -> set:
    """Top-level names of every module that `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_or_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "repro_torch" not in names
    assert not names & {"tests", "portbench_cases"}


def test_the_check_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.models\nfrom jaxtyping import x\n"
                   "import jax.numpy\n")
    assert imported(src) == {"repro_torch", "jaxtyping", "jax"}
    assert imported(src) & FORBIDDEN == {"jax"}
