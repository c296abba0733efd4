"""Port: ``metatts_torch``, ``chip_smoke.py`` and ``bench_torch.py`` import
with JAX, flax, msgpack and optax blocked, and nothing of the port names the
JAX package or imports JAX."""

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "metatts_torch")


def _port_files():
    for d, _, files in os.walk(PKG):
        if os.path.basename(d) in ("build", "__pycache__"):
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".h")):
                yield os.path.join(d, f)


def _modules():
    mods = []
    for path in _port_files():
        if path.endswith(".py"):
            rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
            mods.append(rel[:-len(".__init__")] if rel.endswith("__init__") else rel)
    return sorted(mods)


BLOCKED = ("jax", "flax", "msgpack", "optax")


def test_port_and_smoke_import_without_jax():
    code = (
        "import sys\n"
        f"for b in {BLOCKED!r}:\n"
        "    sys.modules[b] = None\n"          # any `import jax` now raises
        "import importlib\n"
        f"for m in {_modules() + ['chip_smoke', 'bench_torch']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None "
        f"and m.split('.')[0] in {BLOCKED + ('metatts_tpu', 'yaml')!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, ROOT)
                                        for p in _port_files()))
def test_port_file_names_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    assert not re.search(r"metatts_tpu|\bjax\b", text), path


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_smoke_imports_nothing_of_jax():
    names = _imported(os.path.join(ROOT, "chip_smoke.py"))
    assert names and not [n for n in names
                          if n.split(".")[0] in BLOCKED + ("metatts_tpu",)]


def test_bench_imports_nothing_of_jax():
    names = _imported(os.path.join(ROOT, "bench_torch.py"))
    assert names and not [n for n in names
                          if n.split(".")[0] in BLOCKED + ("metatts_tpu",)]


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, ROOT) for p in _port_files()
                                        if p.endswith(".py")))
def test_port_imports_no_flax_msgpack_optax(path):
    assert not [n for n in _imported(os.path.join(ROOT, path))
                if n.split(".")[0] in BLOCKED + ("metatts_tpu",)], path


@pytest.mark.parametrize("module", [
    "metatts_torch.algorithms.adapt", "metatts_torch.algorithms.base",
    "metatts_torch.algorithms.meta", "metatts_torch.models.loss",
    "metatts_torch.ops.attention", "metatts_torch.train.optim",
    "metatts_torch.algorithms", "metatts_torch.algorithms.baseline",
    "metatts_torch.data.prefetch", "metatts_torch.utils.profiling"])
def test_training_slice_modules_are_checked(module):
    """The training slice's modules are among those imported with JAX
    blocked above, and their files among those searched for its name."""
    assert module in _modules()
    assert os.path.join("metatts_torch", "csrc", "flash_attention.cu") in {
        os.path.relpath(p, ROOT) for p in _port_files()}


@pytest.mark.parametrize("module", [
    "metatts_torch.ops.stft", "metatts_torch.ops.melspec",
    "metatts_torch.preprocess", "metatts_torch.preprocess.audio_io",
    "metatts_torch.preprocess.pitch", "metatts_torch.preprocess.textgrid",
    "metatts_torch.preprocess.refmel", "metatts_torch.preprocess.preprocessor",
    "metatts_torch.preprocess.__main__", "metatts_torch.data.dataset"])
def test_preprocessing_slice_modules_are_checked(module):
    """The preprocessing slice's modules are among those imported with JAX
    blocked above, and their files among those searched for its name."""
    assert module in _modules()
    assert os.path.join("metatts_torch", "csrc", "melspec.cu") in {
        os.path.relpath(p, ROOT) for p in _port_files()}


def test_scipy_only_in_preprocess():
    """scipy is imported by the port only in ``metatts_torch/preprocess/``."""
    for path in _port_files():
        if not path.endswith(".py"):
            continue
        rel = os.path.relpath(path, PKG)
        with open(path) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        if any(n.split(".")[0] == "scipy" for n in names):
            assert rel.startswith("preprocess" + os.sep), rel


@pytest.mark.parametrize("module", [
    "metatts_torch.__main__", "metatts_torch.train.checkpoint",
    "metatts_torch.train.loop", "metatts_torch.train.saver",
    "metatts_torch.train.synth_utils", "metatts_torch.train.logging",
    "metatts_torch.data.episodes", "metatts_torch.data.datamodule"])
def test_test_stage_modules_are_checked(module):
    """The test stage's modules are among those imported with JAX, flax,
    msgpack and optax blocked above."""
    assert module in _modules()


@pytest.mark.parametrize("module", [
    "metatts_torch.models.phoneme_embedding", "metatts_torch.data.lang_episodes",
    "metatts_torch.preprocess.prepare_align", "metatts_torch.data.datamodule"])
def test_lang_slice_modules_are_checked(module):
    """The cross-lingual slice's modules are among those imported with JAX
    blocked above, and their files among those searched for its name."""
    assert module in _modules()
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    assert path in set(_port_files())


@pytest.mark.parametrize("module", [
    "metatts_torch.evaluation", "metatts_torch.evaluation.similarity",
    "metatts_torch.evaluation.verification", "metatts_torch.evaluation.mos",
    "metatts_torch.evaluation.dvector", "metatts_torch.evaluation.harness",
    "metatts_torch.evaluation.ge2e_scratch", "metatts_torch.evaluation.mosnet",
    "metatts_torch.evaluation.mbnet", "metatts_torch.evaluation.wav2vec2",
    "metatts_torch.evaluation.visualize", "metatts_torch.evaluation.figures",
    "metatts_torch.evaluate"])
def test_evaluation_slice_modules_are_checked(module):
    """The evaluation slice's modules are among those imported with JAX
    blocked above, and their files among those searched for its name; none
    imports matplotlib, sklearn or yaml at module level (the card machine
    has neither matplotlib nor sklearn, and may lack PyYAML)."""
    assert module in _modules()
    base = os.path.join(ROOT, *module.split("."))
    path = base + ".py" if os.path.exists(base + ".py") else os.path.join(base, "__init__.py")
    assert path in set(_port_files())
    with open(path) as f:
        body = ast.parse(f.read()).body
    top = [a.name for n in body if isinstance(n, ast.Import) for a in n.names]
    top += [n.module for n in body if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in top if n.split(".")[0] in ("matplotlib", "sklearn", "yaml")]
