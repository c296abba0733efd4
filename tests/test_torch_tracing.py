"""Port: the program's spans (``metatts_torch/utils/profiling.py`` ``span``).

On the CPU at the tiny widths: with recording off a span is the shared null
context; recording changes no output; under ``torch.profiler`` every span of
one ``synthesize`` call, one baseline ``train_step`` and one meta step is a
host range of the profiler's trace on the same clock, nested as the records
say; the vocoder's frame counts; the step's waits; the recording that a
span begins under ``profiling.profile`` or ``trace`` ends with it; the
buffer's bound.
"""

import collections
import warnings

import numpy as np
import pytest
import torch

from metatts_torch.algorithms import get_system
from metatts_torch.data.collate import collate_batch, collate_episode
from metatts_torch.models.fastspeech2 import FastSpeech2
from metatts_torch.models.vocoder import Vocoder
from metatts_torch.serve import SynthesisEngine
from metatts_torch.utils import profiling

from helpers import STATS, algorithm_cfg, tiny_model_cfg, tiny_preprocess_cfg, tiny_train_cfg
from torch_port_helpers import one_torch_thread  # noqa: F401

MEL_CAP = 48
SERVE = ["metatts.serve", "metatts.serve.frontend", "metatts.data.collate",
         "metatts.serve.acoustic", "metatts.wait.mel_lens", "metatts.vocoder.net",
         "metatts.to_host.wav", "metatts.to_host.mel"]
TRAIN = ["metatts.train.step", "metatts.train.to_device", "metatts.train.forward",
         "metatts.train.backward", "metatts.train.optimizer", "metatts.wait.clip"]


def _samples(seed, n, n_mels=8):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        L = int(rng.randint(5, 12))
        d = rng.randint(1, 4, size=L).astype(np.int32)
        out.append({"id": f"u{i}", "speaker": i % 4, "raw_text": "",
                    "text": rng.randint(1, 300, size=L).astype(np.int32),
                    "mel": rng.randn(int(d.sum()), n_mels).astype(np.float32),
                    "pitch": rng.randn(L).astype(np.float32),
                    "energy": rng.randn(L).astype(np.float32), "duration": d})
    return out


@pytest.fixture(scope="module")
def parts():
    mcfg, pcfg = tiny_model_cfg(), tiny_preprocess_cfg()
    model = FastSpeech2(pcfg, mcfg, algorithm_cfg("meta"), STATS, 4,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():   # random weights predict ~0 frames a phoneme
        model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(1.6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vocoder = Vocoder(mcfg, n_mels=8, device="cpu")
    engine = SynthesisEngine(model, pcfg, mcfg, algorithm_cfg("meta"), vocoder=vocoder,
                             device="cpu")
    texts = [s["text"] for s in _samples(1, 3)]

    def system(kind, seed=5):
        return get_system(kind)(pcfg, mcfg, tiny_train_cfg(), algorithm_cfg(kind), STATS, 4,
                                seed=seed, device="cpu")

    batch = collate_batch(_samples(2, 3), mcfg["max_seq_len"])[0]
    episode = collate_episode([_samples(3, 2)], [_samples(4, 2)], mcfg["max_seq_len"])[:2]
    calls = {
        "serve": lambda: engine.synthesize(texts, speakers=[0, 1, 2], mel_cap=MEL_CAP),
        "train": lambda s=None: (s or system("baseline")).train_step(batch),
        "meta": lambda s=None: (s or system("meta")).train_step(*episode),
    }
    yield dict(calls=calls, system=system, texts=texts)
    profiling.stop()


def _record(call, recording):
    profiling.start()
    if not recording:
        profiling.stop()
    out = call()
    recs = profiling.records()
    profiling.stop()
    return out, recs


def _flat(out):
    if isinstance(out[0], tuple):    # synthesize: (wav, mel) pairs
        return [np.asarray(a) for pair in out for a in pair]
    return [t.detach().numpy() for t in out]


@pytest.mark.parametrize("kw", [{}, {"device": True}, {"wait": True}])
def test_off_span_is_the_null_context(parts, monkeypatch, kw):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: opened.append(a))
    profiling.start()
    profiling.stop()
    s = profiling.span("metatts.test", **kw)
    assert s is profiling.NULL
    with s as h:
        h.count(frames=3)
    parts["calls"]["serve"]()
    assert profiling.records() == [] and opened == []


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_recording_leaves_outputs_bit_identical(parts, kind):
    runs = []
    for recording in (False, True):
        if kind == "serve":
            out, recs = _record(parts["calls"]["serve"], recording)
        else:
            system = parts["system"]("baseline")
            out, recs = _record(lambda: parts["calls"]["train"](system), recording)
            out = list(out) + [p for p in system.params.values()]
        runs.append(_flat(out))
        assert bool(recs) == recording
    for a, b in zip(*runs):
        assert np.array_equal(a, b)


def _ranges(prof):
    out = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("metatts."):
            out[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("kind,names", [("serve", SERVE), ("train", TRAIN)])
def test_spans_are_the_profilers_host_ranges(parts, kind, names):
    from torch.profiler import ProfilerActivity, profile
    profiling.stop()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        parts["calls"][kind]()
    recs = profiling.records()
    profiling.stop()
    assert sorted({r["name"] for r in recs}) == sorted(names)
    assert len({r["root"] for r in recs}) == 1
    by_id = {r["id"]: r for r in recs}
    root = [r for r in recs if r["parent"] is None]
    assert len(root) == 1 and root[0]["name"] == names[0] and root[0]["id"] == recs[0]["root"]
    ranges = _ranges(prof)
    seen = collections.Counter()
    for r in sorted(recs, key=lambda r: r["id"]):
        s, e = ranges[r["name"]][seen[r["name"]]]
        seen[r["name"]] += 1
        assert abs(r["start_ns"] - s) < 1e6 and abs(r["end_ns"] - e) < 1e6, r
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
    assert seen == collections.Counter({k: len(v) for k, v in ranges.items()})


def test_vocoder_counts_frames_run_and_valid(parts):
    out, recs = _record(parts["calls"]["serve"], True)
    net = [r for r in recs if r["name"] == "metatts.vocoder.net"]
    assert len(net) == 1 and net[0]["device_ms"] > 0
    assert net[0]["counts"] == {"frames_run": len(out) * MEL_CAP,
                                "frames_valid": sum(len(m) for _, m in out)}
    assert 0 < net[0]["counts"]["frames_valid"] < net[0]["counts"]["frames_run"]


@pytest.mark.parametrize("kind,waits", [("train", ["metatts.wait.clip"]),
                                        ("serve", ["metatts.wait.mel_lens", "metatts.to_host.wav",
                                                   "metatts.to_host.mel"])])
def test_waits_under_the_root(parts, kind, waits):
    # on the CPU no copy crosses to a card, so the copies in are no waits
    _, recs = _record(parts["calls"][kind], True)
    assert [r["name"] for r in recs if r["wait"]] == waits
    assert all(r["root"] == recs[-1]["id"] for r in recs)


def test_meta_step_records_its_parts_in_order(parts):
    _, recs = _record(parts["calls"]["meta"], True)
    names = [r["name"] for r in sorted(recs, key=lambda r: r["id"])
             if r["name"].startswith("metatts.meta.")]
    assert names == ["metatts.meta.step", "metatts.meta.inner", "metatts.meta.inner",
                     "metatts.meta.query", "metatts.meta.outer"]
    assert len({r["root"] for r in recs}) == 1


@pytest.mark.parametrize("wrapper", ["profile", "trace"])
@pytest.mark.parametrize("before", [False, True])
def test_profile_ends_the_recording_it_began(tmp_path, wrapper, before):
    from torch.profiler import ProfilerActivity
    profiling.start()
    if not before:
        profiling.stop()
    cm = (profiling.profile(activities=[ProfilerActivity.CPU]) if wrapper == "profile"
          else profiling.trace(str(tmp_path)))
    with cm:
        with profiling.span("metatts.test"):
            pass
    after = profiling.span("metatts.after")
    with after:
        pass
    names = [r["name"] for r in profiling.records()]
    profiling.stop()
    assert (after is profiling.NULL) != before
    assert names == ["metatts.test"] + ["metatts.after"] * before


def test_buffer_keeps_the_newest(parts):
    profiling.start()
    for i in range(profiling.BUFFER + 10):
        with profiling.span("metatts.test") as s:
            s.count(i=i)
    recs = profiling.records()
    profiling.stop()
    assert len(recs) == profiling.BUFFER
    assert recs[0]["counts"] == {"i": 10} and recs[-1]["counts"] == {"i": profiling.BUFFER + 9}
