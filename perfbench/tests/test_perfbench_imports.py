"""No module under perfbench/ imports JAX, the JAX package or its
benchmark folder, and the reference imports nothing of the port:
compared by whole top-level name, since ``repro_torch`` begins with
``repro``."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
EVERYWHERE = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
IN_REFERENCE = EVERYWHERE | {"repro_torch"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(HERE)) for p in FILES])
def test_no_forbidden_import(path):
    banned = IN_REFERENCE if "reference" in path.parts else EVERYWHERE
    found = set(top_level_imports(path)) & banned
    assert not found, f"{path} imports {found}"


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.models\nfrom repro_torch import x\n"
                 "import jaxtyping\n")
    assert set(top_level_imports(f)) & EVERYWHERE == set()
    f.write_text("import repro.core\n")
    assert set(top_level_imports(f)) & EVERYWHERE == {"repro"}
    f.write_text("from jax import numpy\n")
    assert set(top_level_imports(f)) & EVERYWHERE == {"jax"}


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from perfbench import harness
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "repro_torch_extra",
                        types.ModuleType("x"))
    assert "repro" not in harness.forbidden_modules()
