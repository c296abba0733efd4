"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, the check against the reference, the result.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
its configuration (the entry's ``file``), its traffic mix
(``traffic/<traffic>.json``, whose ``entry`` names the driver
``drivers/<entry>.py``), its limits (``limits/<workload>.json``) and each
per-layer metric's reader (``metrics/<name>.py``, or, where there is no
file of the whole name, ``metrics/<name up to its first dot>.py``: one
reader serves ``mfu.serve`` and ``mfu.base``).
"""

import importlib
import importlib.util
import json
import math
import os
import sys
import time

import torch

from . import traffic
from .tracer import Tracer

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "metatts_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_reader(name, folder=os.path.join(HERE, "metrics")):
    """The reader module of per-layer metric ``name``: ``metrics/<name>.py``,
    else ``metrics/<name up to its first dot>.py``."""
    path = os.path.join(folder, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(folder, name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(entry):
    """The driver module of a traffic mix's entry point."""
    return importlib.import_module(f"perfbench.drivers.{entry}")


def cell_metrics(bench, workload, kind):
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that the cell
    reports: those that list it, or list no cells and move a metric it
    reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What a per-layer metric's reader reads."""

    def __init__(self, workload, cell, trace):
        self.workload, self.cell, self.trace = workload, cell, trace
        self.cfg, self.mix = cell.cfg, cell.mix


def run_cell(workload, seed, seconds, trace, device="cuda", bench=None, cfg=None, mix=None,
             limits=None, t_start=None, patch=None):
    """One run; returns (result dict, checks {name: (value, limit)}).
    ``patch(cell)``, if given, is called once the cell has built its system
    or engine, before the first step or request (a fault test breaks the
    timed path with it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = next(w for w in bench["workloads"] if w["name"] == workload)
    if cfg is None:
        entry = next(c for c in bench["configs"] if c["name"] == spec["config"])
        cfg = load_json(os.path.join(ROOT, entry["file"]))
    mix = mix or traffic.load(spec["traffic"])
    limits = limits or load_json(os.path.join(HERE, "limits", workload + ".json"))
    device = torch.device(device)
    cell = driver(mix["entry"]).Cell(cfg, mix, seed, device)
    cell.fault = patch
    cell.setup()
    tracer = Tracer(mix["trace_seconds"], device) if trace else None
    if trace and hasattr(cell, "trace_spans"):
        cell.trace_spans()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    if tracer is not None:
        tracer.start()
    cell.run_window(seconds, tracer)
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    metrics = {}
    if not trace:
        e2e = {**cell.end_to_end(), "setup_s": setup_s}
        for m in cell_metrics(bench, workload, "end_to_end"):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        run = Run(workload, cell, tracer.trace)
        for m in cell_metrics(bench, workload, "per_layer"):
            value = load_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": spec["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": cell.attempted, "failed": cell.failed,
              "metrics": metrics, "device": dev}
    if trace:
        t = tracer.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
    cell.free()
    readings = cell.check()
    checks = {k: (readings.get(k, math.inf), v) for k, v in limits.items()}
    result["correct"] = bool(cell.attempted > 0 and cell.failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values()))
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks
