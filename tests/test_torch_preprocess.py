"""Port: the preprocessing slice as a whole against the TPU package.

A two-speaker corpus of harmonic tones (2 utterances each, ~0.7 s, 22.05
kHz, MFA-style ``phones`` TextGrids) is preprocessed once by the TPU
package's ``Preprocessor`` and once by the port's (``device="cpu"``).  Every
artifact is compared: metadata lines and speakers.json equal, stats.json
within rtol 1e-5, durations equal, mel / pitch / energy within atol 1e-4,
reference slices within atol 1e-5.  The port's ``TTSDataset`` then reads
the same samples as the TPU package's, and they feed a finite FastSpeech2
forward and loss.

Both sides run the one native DIO library (``csrc/world.cpp``): the TPU
side is pointed at the port's build, so the comparison does not depend on
``csrc/libworld.so``, which ``tests/test_preprocess.py`` deletes and
rebuilds.
"""

import json
import os

import numpy as np
import pytest
import torch

from metatts_tpu.data.dataset import TTSDataset as JaxTTSDataset
from metatts_tpu.data.dataset import TextDataset as JaxTextDataset
from metatts_tpu.preprocess import pitch as jpitch
from metatts_tpu.preprocess import refmel as jrefmel
from metatts_tpu.preprocess.preprocessor import Preprocessor as JaxPreprocessor
from metatts_torch import config as C
from metatts_torch.data.collate import collate_batch
from metatts_torch.data.dataset import TextDataset, TTSDataset
from metatts_torch.models.fastspeech2 import FastSpeech2
from metatts_torch.models.loss import fastspeech2_loss
from metatts_torch.ops.melspec import fused_mel_spectrogram
from metatts_torch.preprocess import audio_io, pitch, refmel
from metatts_torch.preprocess.preprocessor import OnlineScaler, Preprocessor

from helpers import algorithm_cfg, tiny_model_cfg
from torch_port_helpers import one_torch_thread  # noqa: F401

SR = 22050
PHONES = ["sil", "HH", "AH0", "sp", "L", "OW1", ""]
ATOL = 1e-4


def write_textgrid(path, phones, sec_per_phone):
    """A long-form TextGrid with one ``phones`` tier."""
    t, items = 0.0, []
    for p in phones:
        items.append((t, t + sec_per_phone, p))
        t += sec_per_phone
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0.0", f"xmax = {t}", "tiers? <exists>", "size = 1",
             "item []:", "\titem [1]:", '\t\tclass = "IntervalTier"',
             '\t\tname = "phones"', "\t\txmin = 0.0", f"\t\txmax = {t}",
             f"\t\tintervals: size = {len(items)}"]
    for i, (s, e, p) in enumerate(items):
        lines += [f"\t\tintervals [{i + 1}]:", f"\t\t\txmin = {s}",
                  f"\t\t\txmax = {e}", f'\t\t\ttext = "{p}"']
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


def make_corpus(root, rng):
    """raw/<set>/<spk>/<base>.{wav,lab} + TextGrid/<spk>/<base>.TextGrid."""
    raw = os.path.join(root, "raw")
    for spk, f0, sec in (("spk_a", 120.0, 0.1), ("spk_b", 210.0, 0.11)):
        for u in range(2):
            base = f"{spk}_utt{u}"
            t = np.arange(int(SR * sec * len(PHONES))) / SR
            f = f0 * (1 + 0.05 * np.sin(2 * np.pi * (u + 1) * t))
            wav = 0.4 * np.sin(2 * np.pi * np.cumsum(f) / SR)
            wav += 0.1 * np.sin(4 * np.pi * np.cumsum(f) / SR)
            wav *= 0.2 + 0.8 * np.abs(np.sin(np.pi * (u + 1.5) * t))   # loud and quiet phones
            wav += 0.01 * rng.randn(len(t))
            d = os.path.join(raw, "train", spk)
            os.makedirs(d, exist_ok=True)
            audio_io.save_wav(os.path.join(d, f"{base}.wav"), wav.astype(np.float32), SR)
            with open(os.path.join(d, f"{base}.lab"), "w") as fh:
                fh.write(f"hello {u}")
            for out in ("jax", "port"):
                write_textgrid(os.path.join(root, out, "TextGrid", spk,
                                            f"{base}.TextGrid"), PHONES, sec)
    return raw


def _cfg(raw, out):
    return C.deep_merge(C.PREPROCESS_DEFAULTS, {
        "dataset": "synth",
        "path": {"raw_path": raw, "preprocessed_path": out},
        "subsets": {"train": "train", "val": "train", "test": "train"}})


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    raw = make_corpus(root, np.random.RandomState(0))
    jcfg, pcfg = _cfg(raw, os.path.join(root, "jax")), _cfg(raw, os.path.join(root, "port"))
    assert pitch.f0_backend() == "native-dio"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpitch, "_lib", pitch._load_native())
        jouts = JaxPreprocessor(jcfg).build_from_path()
    pre = Preprocessor(pcfg, device="cpu")
    before = fused_mel_spectrogram.launches
    outs = pre.build_from_path()
    assert fused_mel_spectrogram.launches == before        # the CPU path
    return jcfg, pcfg, jouts, outs, pre


def _files(cfg, sub):
    d = os.path.join(cfg["path"]["preprocessed_path"], sub)
    return sorted(os.listdir(d)), d


def test_metadata_and_speakers_equal(corpus):
    jcfg, pcfg, jouts, outs, _ = corpus
    assert outs == jouts and len(outs["train"]) == 4
    for name in ("train.txt", "speakers.json"):
        with open(os.path.join(jcfg["path"]["preprocessed_path"], name)) as f:
            ref = f.read()
        with open(os.path.join(pcfg["path"]["preprocessed_path"], name)) as f:
            assert f.read() == ref


def test_stats_equal(corpus):
    jcfg, pcfg = corpus[:2]
    load = lambda c: json.load(open(os.path.join(c["path"]["preprocessed_path"],
                                                 "stats.json")))
    ref, got = load(jcfg), load(pcfg)
    assert set(got) == set(ref) == {"pitch", "energy"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=0)


@pytest.mark.parametrize("sub,atol", [("duration", 0), ("mel", ATOL),
                                      ("pitch", ATOL), ("energy", ATOL),
                                      ("spk_ref_mel_slices", 1e-5)])
def test_artifacts_equal(corpus, sub, atol):
    jcfg, pcfg = corpus[:2]
    ref_names, ref_dir = _files(jcfg, sub)
    names, d = _files(pcfg, sub)
    assert names == ref_names and len(names) == 4
    for n in names:
        with open(os.path.join(ref_dir, n), "rb") as f, open(os.path.join(d, n), "rb") as g:
            ref_bytes, got_bytes = f.read(), g.read()
        if not atol:
            assert got_bytes == ref_bytes, n
        ref, got = np.load(os.path.join(ref_dir, n)), np.load(os.path.join(d, n))
        # same .npy header: dtype, shape and memory order
        assert got_bytes[:len(got_bytes) - got.nbytes] == ref_bytes[:len(ref_bytes) - ref.nbytes], n
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=n)


def test_artifact_shapes(corpus):
    _, pcfg, _, outs, pre = corpus
    out = pcfg["path"]["preprocessed_path"]
    for line in outs["train"]:
        base, spk, text, raw = line.split("|")
        load = lambda sub, kind: np.load(os.path.join(out, sub, f"{spk}-{kind}-{base}.npy"))
        dur = load("duration", "duration")
        assert load("mel", "mel").shape == (dur.sum(), 80)
        assert load("pitch", "pitch").shape == load("energy", "energy").shape == dur.shape
        assert load("spk_ref_mel_slices", "mel").shape[1:] == (160, 40)
        assert text == "{HH AH0 sp L OW1}" and raw.startswith("hello")
    assert all(v > 0 for v in pre.seconds.values())


def test_dataset_samples_equal(corpus):
    jcfg, pcfg = corpus[:2]
    ref = JaxTTSDataset("train.txt", jcfg, spk_refer_wav=True)
    ds = TTSDataset("train.txt", pcfg, spk_refer_wav=True)
    assert len(ds) == len(ref) == 4
    for i in range(len(ds)):
        a, b = ds[i], ref[i]
        assert a.keys() == b.keys() and ds.speaker_label(i) == ref.speaker_label(i)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=0, err_msg=k)
            else:
                assert a[k] == b[k], k
    text = os.path.join(pcfg["path"]["preprocessed_path"], "train.txt")
    jt, t = JaxTextDataset(text, jcfg), TextDataset(text, pcfg)
    for i in range(len(t)):
        a, b = t[i], jt[i]
        assert a["id"] == b["id"] and a["speaker"] == b["speaker"]
        assert np.array_equal(a["text"], b["text"])


def test_forward_on_preprocessed_batch(corpus):
    _, pcfg = corpus[:2]
    out = pcfg["path"]["preprocessed_path"]
    ds = TTSDataset("train.txt", pcfg)
    batch, _ = collate_batch([ds[i] for i in range(len(ds))])
    with open(os.path.join(out, "stats.json")) as f:
        stats = json.load(f)
    mcfg = tiny_model_cfg()
    model = FastSpeech2(pcfg, mcfg, algorithm_cfg("meta"), stats, 2,
                        generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        output = model(batch)
        losses = fastspeech2_loss(batch, output, pcfg)
    assert output.postnet_mel.shape[-1] == 80
    assert all(torch.isfinite(v) for v in losses)


def test_online_scaler_is_the_tpu_packages():
    from metatts_tpu.preprocess.preprocessor import OnlineScaler as JaxScaler
    rng = np.random.RandomState(3)
    a, b = OnlineScaler(), JaxScaler()
    for n in (5, 0, 17, 1):
        x = rng.randn(n) * 3 + 2
        a.partial_fit(x)
        b.partial_fit(x)
    assert (a.n, a.mean, a.m2, a.std) == (b.n, b.mean, b.m2, b.std)


def test_f0_native_and_yin_are_the_tpu_packages():
    t = np.arange(int(SR * 0.5)) / SR
    x = 0.5 * np.sin(2 * np.pi * 150 * t) + 0.01 * np.random.RandomState(4).randn(len(t))
    per = 256 / SR * 1000
    native = pitch.extract_f0(x, SR, per, use_native="require")
    assert len(native) == pitch.n_frames(len(x), SR, per) and (native > 0).any()
    np.testing.assert_array_equal(pitch.yin_f0(x, SR, per), jpitch.yin_f0(x, SR, per))
    np.testing.assert_array_equal(pitch.extract_f0(x, SR, per, use_native=False),
                                  jpitch.yin_f0(x, SR, per))


def test_ref_mel_slices_are_the_tpu_packages():
    x = np.random.RandomState(5).randn(int(SR * 2.3)).astype(np.float32) * 0.1
    np.testing.assert_allclose(refmel.ref_mel_slices(x, SR),
                               jrefmel.ref_mel_slices(x, SR), atol=1e-5, rtol=0)


def test_cli_on_the_cpu(corpus, tmp_path):
    """``python -m metatts_torch.preprocess <yaml> --device cpu`` writes what
    the fixture's ``Preprocessor`` wrote."""
    import shutil
    import yaml
    from metatts_torch.preprocess.__main__ import main
    _, pcfg, _, outs, _ = corpus
    out = str(tmp_path / "out")
    shutil.copytree(os.path.join(pcfg["path"]["preprocessed_path"], "TextGrid"),
                    os.path.join(out, "TextGrid"))
    path = tmp_path / "corpus.yaml"
    path.write_text(yaml.safe_dump({"dataset": "synth", "path": {
        "raw_path": pcfg["path"]["raw_path"], "preprocessed_path": out},
        "subsets": pcfg["subsets"]}))
    main([str(path), "--device", "cpu"])
    with open(os.path.join(out, "train.txt")) as f:
        assert f.read().splitlines() == outs["train"]
    for name in ("stats.json", "speakers.json"):
        with open(os.path.join(out, name)) as f, \
                open(os.path.join(pcfg["path"]["preprocessed_path"], name)) as g:
            assert json.load(f) == json.load(g)


def test_preprocessor_refuses_cpu_only_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the preprocessor would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Preprocessor(_cfg(str(tmp_path), str(tmp_path)))
