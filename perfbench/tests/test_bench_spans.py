"""The readers of the program's spans (``perfbench/spans.py`` and the eight
``metrics/*.py`` it serves): a traced run of each tiny cell on the CPU reads
every one of them; the vocoded share is the served mels' frames over the
padded frames; the trace's idle gaps fall to the program's spans; a span's
own host time leaves out the waits inside it; and with recording never on
every reader gives None."""

import math

import pytest

from perfbench import harness, spans, tracer
from perfbench.tests import tiny
from perfbench.tests.test_bench_faults import SEED, limits

NEW = {"serve-b8": ["frontend_span_ms.serve", "acoustic_span_ms.serve", "melgan_span_ms.serve",
                    "to_host_span_ms.serve", "vocoded_valid_share.serve"],
       "base-train-b80": ["collate_span_ms.base", "optimizer_span_ms.base",
                          "host_waits_per_step.base"]}


@pytest.fixture(scope="module")
def runs():
    import torch
    from metatts_torch.utils import profiling
    # one thread: beside other test processes a full pool oversubscribes the
    # cores and a tiny unit can outlast the window
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for cell in tiny.CELLS:
        got = {}

        def keep(c):
            got["cell"] = c
            window = c.run_window

            def run_window(seconds, t=None):
                got["tracer"] = t
                return window(seconds, t)
            c.run_window = run_window
        profiling.stop()
        # a window long enough that units begin after the trace is read
        res, checks = harness.run_cell(cell, SEED, 3.0, True, limits=limits(cell), patch=keep,
                                       **tiny.cell_args(cell))
        assert res["correct"], checks
        out[cell] = (res, got["cell"], got["tracer"])
    torch.set_num_threads(threads)
    yield out
    profiling.stop()


@pytest.mark.parametrize("cell,name", [(c, n) for c, names in NEW.items() for n in names])
def test_every_new_metric_reads(runs, cell, name):
    res = runs[cell][0]
    assert name in [m["name"] for m in harness.cell_metrics(tiny.bench(), cell, "per_layer")]
    value = res["metrics"][name]["value"]
    assert math.isfinite(value) and value > 0, (name, value)


def test_vocoded_share_is_the_served_frames(runs):
    res, cell, _ = runs["serve-b8"]
    mels = [sum(cell.unit_lengths(r)[1]) for r in cell.records]
    frames = sum(len(cell.pool[r["unit"]]) for r in cell.records) * cell.mix["mel_cap"]
    assert res["metrics"]["vocoded_valid_share.serve"]["value"] == pytest.approx(
        100.0 * sum(mels) / frames, rel=1e-12)


class _OnDevice:
    """A host operation of the CPU's trace put on the device's timeline."""

    def __init__(self, e):
        self.e = e

    def device_type(self):
        return "DeviceType.CUDA"

    def __getattr__(self, name):
        return getattr(self.e, name)


@pytest.mark.parametrize("cell,harness_range", [("serve-b8", "perfbench.request"),
                                                ("base-train-b80", "perfbench.step")])
def test_idle_gaps_fall_to_the_programs_spans(runs, cell, harness_range):
    """The CPU has no device timeline: the trace's aten operations stand in
    for the device's, so the host's work between them is idle time, which
    ``Trace.idle_gaps`` charges to the innermost host range open."""
    t = runs[cell][2]
    events = [_OnDevice(e) if e.name().startswith("aten::") else e
              for e in t.prof.profiler.kineto_results.events()]
    gaps = dict(tracer.Trace(events, t.trace.window_s, t.trace.units).idle_gaps(n=1000))
    ours = sum(v for k, v in gaps.items() if k.startswith("metatts."))
    assert ours > 0 and gaps.get(harness_range, 0.0) < 0.1 * ours, gaps


def test_own_time_leaves_out_the_waits_inside():
    def rec(id, parent, name, ms, wait=False):
        return {"id": id, "parent": parent, "name": name, "host_ms": ms, "wait": wait}
    call = [rec(1, None, "metatts.train.step", 100.0),
            rec(2, 1, "metatts.train.optimizer", 90.0),
            rec(3, 2, "metatts.wait.clip", 30.0, wait=True),
            rec(4, 3, "metatts.wait.inner", 10.0, wait=True),
            rec(5, 1, "metatts.wait.to_device", 5.0, wait=True)]
    assert spans.own(call, "metatts.train.optimizer") == 60.0
    assert spans.own(call, "metatts.train.step") == 65.0
    assert spans.own(call, "metatts.train.forward") is None


def test_readers_give_none_without_records(runs):
    from metatts_torch.utils import profiling
    profiling.start()
    profiling.stop()
    for cell, names in NEW.items():
        _, c, t = runs[cell]
        run = harness.Run(cell, c, t.trace)
        assert [harness.load_reader(n).read(run) for n in names] == [None] * len(names)
