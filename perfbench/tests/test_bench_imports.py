"""The import rule: nothing under perfbench/ imports a module whose
top-level name is jax, jaxlib, flax or metatts_tpu (names compared whole:
metatts_torch begins with the JAX package's name and is allowed); the
reference imports nothing of metatts_torch; nothing reads the JAX
package's bench files or the smoke; and a run's process holds none of
them."""

import ast
import glob
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "metatts_tpu"}


def imported(path):
    """Top-level names of every module a file imports."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                out.add(arg.value.split(".")[0])
    return out


def sources():
    return sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


def test_no_file_imports_jax_or_the_jax_package():
    for path in sources():
        bad = imported(path) & FORBIDDEN
        assert not bad, (path, bad)


def test_names_are_compared_whole():
    assert "metatts_torch".split(".")[0] not in FORBIDDEN
    assert "metatts_tpu.ops".split(".")[0] in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        names = imported(path)
        assert "metatts_torch" not in names and not names & FORBIDDEN, (path, names)
        text = open(path).read()
        assert "metatts_torch" not in text.replace("the program", "")


def literals(path):
    """String constants of a file that are not docstrings (the names a
    program could open or run)."""
    tree = ast.parse(open(path).read())
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant):
            docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_nothing_reads_the_jax_benchmark_or_the_smoke():
    for path in sources():
        if os.path.basename(path) == "test_bench_imports.py":
            continue
        for text in literals(path):
            for name in ("bench.py", "BENCH_", "MULTICHIP_", "BASELINE.json", "chip_smoke"):
                assert name not in text, (path, name, text)


def test_a_run_holds_none_of_them():
    code = (
        "import sys, torch\n"
        "from perfbench import harness\n"
        "from perfbench.tests import tiny\n"
        "harness.run_cell('serve-b8', 5, 0.2, False, **tiny.cell_args('serve-b8'))\n"
        "print('HELD', harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert "HELD []" in out.stdout, out.stderr[-2000:]
