"""On the card, at each cell's own size: the control (the reference put in
the program's place at the precision below the configuration's) fails the
cell's limits.  Skipped without a CUDA device.  ``control.py`` makes the
same readings over many seeds in one process."""

import json
import os

import pytest
import torch

from perfbench import control, harness, traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", cells())
def test_control_fails_the_limits(card, workload):
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == spec["config"])
    cfg = harness.load_json(os.path.join(ROOT, entry["file"]))
    mix = traffic.load(spec["traffic"])
    limits = harness.load_json(os.path.join(BENCH, "limits", workload + ".json"))
    cell = harness.driver(mix["entry"]).Cell(cfg, mix, 2 ** 31 + 99, card)
    cell.setup()
    cell.free()
    low = control.control_readings(cell)
    assert any(low[k] > v for k, v in limits.items()), (low, limits)
    torch.cuda.empty_cache()
