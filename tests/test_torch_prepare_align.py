"""Port: ``prepare_align`` against the JAX package's on the same corpora.

A LibriTTS tree (24 kHz wavs with ``.normalized.txt`` transcripts in two
subsets of the ``train-clean`` group, a wav without a transcript and a
stray file) and a VCTK tree (``wav48_silence_trimmed`` mic2 flacs from
tests/flac_encoder.py with their mic1 twins, and a mic1-only utterance)
are normalised to ``raw_path`` by both packages: the same files, the same
``.lab`` bytes and the same int16 samples at 22.05 kHz.  Both sides decode
FLAC with the one native library built from ``csrc/flac.cpp``: the JAX
side is pointed at the port's build, so the comparison does not depend on
``csrc/libworld.so``, which ``tests/test_preprocess.py`` deletes and
rebuilds.
"""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from metatts_tpu.preprocess import pitch as jpitch
from metatts_tpu.preprocess import prepare_align as jpa
from metatts_torch import config as C
from metatts_torch.preprocess import pitch
from metatts_torch.preprocess import prepare_align as pa

from flac_encoder import encode_flac

TEXTS = ["Mr. Smith paid $5 for 3 apples.", "Hello, world!", "It's 10:30 on Dr. Who's clock."]


def _cfg(dataset, corpus, raw):
    return C.deep_merge(C.PREPROCESS_DEFAULTS, {
        "dataset": dataset, "path": {"corpus_path": corpus, "raw_path": raw},
        "subsets": {"train": "train-clean", "val": "dev-clean", "test": "test-clean"}})


def _tone(rng, sr, sec, f0):
    t = np.arange(int(sr * sec)) / sr
    return 0.4 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.randn(len(t))


def _tree(root):
    """relative path -> file bytes of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _assert_same_output(port_raw, jax_raw, n):
    got, ref = _tree(port_raw), _tree(jax_raw)
    assert sorted(got) == sorted(ref) and len(got) == 2 * n
    for rel, data in ref.items():
        if rel.endswith(".lab"):
            assert got[rel] == data, rel
        else:
            (sr_a, a), (sr_b, b) = (wavfile.read(os.path.join(r, rel))
                                    for r in (port_raw, jax_raw))
            assert sr_a == sr_b == 22050 and a.dtype == b.dtype == np.int16, rel
            np.testing.assert_array_equal(a, b, err_msg=rel)
            assert np.abs(a).max() == 32767                # peak-normalised


def test_expand_subsets_matches_jax():
    for s in ("train-clean", "train-all", "dev-clean", ["train-clean", "test-other"]):
        assert pa.expand_subsets(s) == jpa.expand_subsets(s)


def test_prepare_align_libritts_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    corpus = tmp_path / "corpus"
    n = 0
    for subset, spk, chapter in (("train-clean-100", "19", "198"), ("train-clean-100", "26", "495"),
                                 ("train-clean-360", "1034", "121119"),
                                 ("dev-clean", "84", "121123")):
        d = corpus / subset / spk / chapter
        d.mkdir(parents=True)
        for u, text in enumerate(TEXTS[:2]):
            base = f"{spk}_{chapter}_{u:06d}_000000"
            wavfile.write(d / f"{base}.wav", 24000,
                          (_tone(rng, 24000, 0.3 + 0.1 * u, 100 + 20 * u) * 20000).astype(np.int16))
            (d / f"{base}.normalized.txt").write_text(text + "\n")
            n += 1
        wavfile.write(d / f"{spk}_{chapter}_000009_000000.wav", 24000,
                      np.zeros(100, np.int16))             # no transcript: skipped
        (d / "notes.txt").write_text("not an utterance")
    (corpus / "train-clean-100" / "README").write_text("a stray file")
    got = pa.prepare_align(_cfg("LibriTTS", str(corpus), str(tmp_path / "port")))
    ref = jpa.prepare_align(_cfg("LibriTTS", str(corpus), str(tmp_path / "jax")))
    assert got == ref == n
    _assert_same_output(tmp_path / "port", tmp_path / "jax", n)
    assert os.listdir(tmp_path / "port") and "train-clean-360" in os.listdir(tmp_path / "port")


def test_prepare_align_vctk_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    corpus = tmp_path / "corpus"
    n = 0
    for spk in ("p225", "p226"):
        wdir, tdir = corpus / "wav48_silence_trimmed" / spk, corpus / "txt" / spk
        wdir.mkdir(parents=True)
        tdir.mkdir(parents=True)
        for u, text in enumerate(TEXTS):
            base = f"{spk}_{u + 1:03d}"
            for mic in ("mic1", "mic2"):
                x = (_tone(rng, 48000, 0.2, 150 + 30 * u) * 30000).astype(np.int32)
                (wdir / f"{base}_{mic}.flac").write_bytes(encode_flac(x, 48000))
            (tdir / f"{base}.txt").write_text(text + "\n")
            n += 1
        (wdir / f"{spk}_009_mic1.flac").write_bytes(encode_flac(
            np.zeros(480, np.int32), 48000))               # mic1 only: skipped
        (tdir / f"{spk}_009.txt").write_text("Ask her to bring these things.\n")
    assert pitch.f0_backend() == "native-dio"
    got = pa.prepare_align(_cfg("VCTK", str(corpus), str(tmp_path / "port")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpitch, "_lib", pitch._load_native())
        ref = jpa.prepare_align(_cfg("VCTK", str(corpus), str(tmp_path / "jax")))
    assert got == ref == n
    _assert_same_output(tmp_path / "port", tmp_path / "jax", n)
    assert sorted(os.listdir(tmp_path / "port" / "all")) == ["p225", "p226"]


def test_prepare_align_cli(tmp_path, capsys):
    """``python -m metatts_torch.preprocess.prepare_align <yaml>`` prints
    the root ``prepare_align.py``'s line per config."""
    d = tmp_path / "corpus" / "train-clean-100" / "19" / "198"
    d.mkdir(parents=True)
    wavfile.write(d / "19_198_000000_000000.wav", 24000,
                  (_tone(np.random.RandomState(2), 24000, 0.2, 120) * 20000).astype(np.int16))
    (d / "19_198_000000_000000.normalized.txt").write_text("Hello.\n")
    yml = tmp_path / "pp.yaml"
    yml.write_text(f"dataset: LibriTTS\npath: {{corpus_path: {tmp_path / 'corpus'}, "
                   f"raw_path: {tmp_path / 'raw'}}}\nsubsets: {{train: train-clean-100}}\n")
    pa.main([str(yml)])
    assert capsys.readouterr().out == f"LibriTTS: wrote 1 utterances to {tmp_path / 'raw'}\n"
    with open(tmp_path / "raw" / "train-clean-100" / "19" / "19_198_000000_000000.lab") as f:
        assert f.read() == "hello."
