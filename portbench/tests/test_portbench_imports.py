"""Nothing under ``portbench/`` imports JAX, Flax or the JAX package, by whole
top-level names (``cask_tpu_torch`` begins with ``cask_tpu`` and is allowed),
and the reference imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "cask_tpu"}
SOURCES = sorted(p for p in spec.PACKAGE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(spec.ROOT).as_posix())
def test_no_forbidden_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_top_level_names_compared_whole():
    from portbench.harness import FORBIDDEN as harness_forbidden, forbidden_modules

    assert set(harness_forbidden) == FORBIDDEN
    sys.modules.setdefault("cask_tpu_torch_lookalike", sys)
    assert "cask_tpu_torch_lookalike" not in forbidden_modules()


def test_references_import_nothing_of_the_port():
    for path in (spec.PACKAGE / "families").glob("*.py"):
        tree = ast.parse(path.read_text())
        ref = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "Reference"]
        for cls in ref:
            names = {a.name for n in ast.walk(cls) if isinstance(n, ast.Import) for a in n.names}
            names |= {n.module for n in ast.walk(cls) if isinstance(n, ast.ImportFrom)}
            assert not {m for m in names if m and m.startswith("cask_tpu")}, path


def test_a_run_loads_no_forbidden_module(tmp_path):
    code = (
        "import sys, time\n"
        "from portbench.tests.tiny import tiny_bench, run_tiny\n"
        "import pathlib\n"
        f"b = tiny_bench(pathlib.Path({str(tmp_path)!r}))\n"
        "for w in ('hpcg-512.cg', 'fem-dof4-419m.spmv'):\n"
        "    assert run_tiny(b, w)['correct']\n"
        "from portbench.harness import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
