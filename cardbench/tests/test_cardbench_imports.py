"""What the benchmark imports: no module under ``cardbench/`` imports JAX or
the JAX package (each import's top-level name, the part before the first
dot, compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the port either."""

import ast
import sys

import pytest

from helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "oscar_mpc_planner_mr_modification_tpu"}
PORT = "oscar_mpc_planner_mr_modification_tpu_torch"


def imports(path):
    """Top-level names of every absolute import in a file, and whether it
    has relative imports that leave its own package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted((ROOT / "cardbench").rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT / "cardbench")))
def test_no_jax_anywhere(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (ROOT / "cardbench" / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = imports(path)
    assert PORT not in names
    allowed = {"__future__", "math", "typing", "numpy", "torch"}
    assert names <= allowed, names - allowed
    text = path.read_text()
    assert "from .." not in text  # nothing outside the reference itself


def test_forbidden_names_are_compared_whole():
    """The port's name starts with the JAX package's: a prefix test would
    flag the port."""
    from cardbench import run

    saved = dict(sys.modules)
    try:
        sys.modules.pop("oscar_mpc_planner_mr_modification_tpu", None)
        sys.modules.setdefault(PORT, object())
        assert "oscar_mpc_planner_mr_modification_tpu" not in \
            run.forbidden_loaded()
        sys.modules["jaxlib.xla_client"] = object()
        assert "jaxlib" in run.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
