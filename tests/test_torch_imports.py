"""The port stands alone: no module of tutel_tpu_torch, and neither
chip_smoke.py nor a script in tools/, imports jax or the JAX package
tutel_tpu. Names are compared exactly or by the prefixes "jax." and
"tutel_tpu.", since "tutel_tpu_torch" itself starts with "tutel_tpu"."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "tutel_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "tutel_tpu")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_the_name_check_is_exact():
    assert _forbidden("jax.numpy") and _forbidden("tutel_tpu.ops")
    assert not _forbidden("tutel_tpu_torch.ops") and not _forbidden("jaxlib2")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted({n for n in _imports(tree) if _forbidden(n)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
