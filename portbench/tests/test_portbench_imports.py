"""What the benchmark may import: no JAX, no JAX package, nothing of the
repo's JAX-side benchmarks or experiments anywhere under ``portbench/``,
and nothing of the port in the reference.  Top-level module names are
compared whole: ``repro_torch`` begins with ``repro`` and is the port."""
import ast
from pathlib import Path

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "experiments"}
FILES = sorted(p for p in harness.BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax_side_imports(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((harness.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)
    assert not top_level_imports(path) & {"portbench"}     # relative imports only: its own


def test_names_are_compared_whole():
    assert harness.forbidden_modules() == []          # repro_torch may be loaded; repro is not
    assert "repro_torch".split(".")[0] not in harness.FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_reads_no_jax_side_files(path):
    text = path.read_text()
    for d in ("benchmarks/", "experiments/", "src/repro/"):
        assert d not in text
