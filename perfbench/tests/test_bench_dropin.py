"""Driven by data: a configuration, a traffic mix, a per-layer metric and
a cell dropped in as new files (and entries in BENCHMARK.json) are found
by name and run, with no file that was there edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from perfbench.tests import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def digests(folder):
    out = {}
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, folder)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    os.symlink(os.path.join(ROOT, "metatts_torch"), root / "metatts_torch")
    before = digests(root / "perfbench")

    # the new configuration, traffic mix, limits and metric, each a file
    (root / "perfbench/configs/tiny-drop.json").write_text(
        json.dumps(tiny.config("metatts-libritts-meta")))
    (root / "perfbench/traffic/tiny-serve.json").write_text(json.dumps(tiny.mix("serve-b8")))
    (root / "perfbench/limits/tiny-serve-cell.json").write_text(json.dumps(
        {"length_mismatch": 0, "mel_gap": 0.05, "wav_gap": 0.1}))
    (root / "perfbench/metrics/requests_traced.tiny.py").write_text(
        '"""Requests in the traced part of the window."""\n\n\n'
        "def read(run):\n    return float(run.trace.units)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-drop", "source": "https://example.org/tiny",
                             "file": "perfbench/configs/tiny-drop.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny-serve-cell", "config": "tiny-drop",
                               "traffic": "tiny-serve", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "requests_traced.tiny", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "serving", "moves": "audio_s_per_s",
                               "workloads": ["tiny-serve-cell"]})
    # a new cell's split of a metric whose reader is there: no file at all
    bench["per_layer"].append({"name": "acoustic_ms.tiny", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "acoustic model",
                               "moves": "request_p95_ms", "workloads": ["tiny-serve-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json\n"
            "from perfbench import harness\n"
            "res, _ = harness.run_cell('tiny-serve-cell', 9, 0.5, True, device='cpu')\n"
            "print('RESULT', json.dumps(res))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=600)
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT")]
    assert line, out.stderr[-3000:]
    res = json.loads(line[0][len("RESULT "):])
    assert res["metrics"]["requests_traced.tiny"]["value"] >= 1
    assert res["metrics"]["acoustic_ms.tiny"]["value"] > 0
    assert res["correct"] is True
    after = digests(root / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before
