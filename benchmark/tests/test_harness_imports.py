"""What the benchmark may import: nothing of JAX, its libraries or the JAX
package anywhere, compared by whole top-level name (the port's name begins
with the JAX package's), and nothing of the program in the reference."""

import ast
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "runet_tpu"}
ON_CHIP = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_are_found():
    assert HERE / "run.py" in ON_CHIP and HERE / "reference" / "unet.py" in ON_CHIP


@pytest.mark.parametrize("path", ON_CHIP, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "runet_tpu_torch" not in top_level_imports(path)


def test_run_names_loaded_banned_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "runet_tpu.config", types.ModuleType("runet_tpu.config"))
    assert "runet_tpu" in run.banned_modules()
    monkeypatch.delitem(sys.modules, "runet_tpu.config")
    monkeypatch.setitem(sys.modules, "runet_tpu_torchx", types.ModuleType("runet_tpu_torchx"))
    assert "runet_tpu" not in run.banned_modules()
