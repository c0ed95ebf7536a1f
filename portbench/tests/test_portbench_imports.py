"""Nothing the benchmark runs loads JAX or the JAX package (compared by the
whole top-level module name: the port's name begins with the JAX
package's), and nothing of it reads the repository's ``benchmarks/``."""

import ast
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "probly_search_tpu"}
PORT = "probly_search_tpu_torch"


def _imports(source):
    """Top-level names of the modules that ``source`` (a path or a tree)
    imports, anywhere in it."""
    tree = ast.parse(source.read_text()) if isinstance(source, Path) else source
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_and_the_yardstick_import_no_program():
    reference = sorted(BENCH.glob("reference/**/*.py"))
    assert reference
    yardstick = [BENCH / f for f in ("counts.py", "corpus.py", "check.py", "control.py", "manifest.py")]
    for path in reference + yardstick:
        assert PORT not in set(_imports(path)), path


def test_a_scorer_imports_the_port_only_inside_program():
    """A scorer's reference stays independent of the program: the port is
    imported in ``program`` alone, never at module level."""
    paths = sorted(BENCH.glob("scorers/*.py"))
    assert paths
    for path in paths:
        tree = ast.parse(path.read_text())
        program = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "program"]
        assert len(program) == 1, path
        outside = ast.Module([n for n in tree.body if n is not program[0]], [])
        assert PORT not in set(_imports(outside)), path


def test_nothing_opens_the_repository_benchmarks_folder():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and '"benchmarks"' not in text, path


def test_a_run_leaves_no_forbidden_module_loaded():
    """A whole run of a small cell (CPU), then the run's own guard."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny_cell\n"
        "from portbench import run\n"
        "res = run.run_cell(tiny_cell('msmarco-1m.bm25'), 11, 0.5, False, 'cpu')\n"
        "assert res['correct'], res\n"
        "print('FOUND', run.forbidden_modules())\n"
    ) % (str(ROOT), str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"


def test_the_guard_compares_whole_names(monkeypatch):
    from portbench import run

    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "probly_search_tpu_torchy.sub", sys)
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "probly_search_tpu.index", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"jax", "probly_search_tpu"} <= set(run.forbidden_modules())
