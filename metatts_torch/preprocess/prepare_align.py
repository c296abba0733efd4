"""Corpus normalisation to ``raw_data/`` (reference ``prepare_align.py`` +
``preprocessor/{libritts,vctk}.py``): resample to the configured rate,
peak-normalise to int16, clean transcripts into ``.lab`` files.

    python -m metatts_torch.preprocess.prepare_align <preprocess.yaml> [more.yaml ...]

LibriTTS layout: <corpus>/<subset>/<speaker>/<chapter>/<base>.wav with
``<base>.normalized.txt`` transcripts.  VCTK: ``wav48_silence_trimmed``
(or ``wav48``, ``wav``) mic2 flacs, decoded by the native FLAC decoder
(``audio_io.load_flac``), with ``txt/<speaker>/<base>.txt`` transcripts
(reference ``preprocessor/vctk.py:11-46``).  Host code only: nothing here
runs on a card.
"""

import argparse
import os

import numpy as np

from ..text import _clean_text
from .audio_io import load_wav, save_wav

SUBSET_GROUPS = {
    "train-clean": ["train-clean-100", "train-clean-360"],
    "train-all": ["train-clean-100", "train-clean-360", "train-other-500"],
}


def expand_subsets(subsets):
    """train-clean -> [train-clean-100, train-clean-360] etc.
    (reference ``prepare_align.py:8-35``)."""
    out = []
    for s in subsets if isinstance(subsets, list) else [subsets]:
        out += SUBSET_GROUPS.get(s, [s])
    return out


def _write_utterance(out_dir, speaker, base, wav_path, text, sr):
    """The utterance resampled to ``sr`` and peak-normalised as an int16
    wav, and its cleaned transcript as ``.lab``."""
    wav, _ = load_wav(wav_path, target_sr=sr)
    wav = wav / max(np.abs(wav).max(), 1e-9)
    os.makedirs(os.path.join(out_dir, speaker), exist_ok=True)
    save_wav(os.path.join(out_dir, speaker, f"{base}.wav"), wav, sr)
    with open(os.path.join(out_dir, speaker, f"{base}.lab"), "w") as f:
        f.write(text)


def _sorted_dirs(path):
    return [n for n in sorted(os.listdir(path)) if os.path.isdir(os.path.join(path, n))]


def prepare_align_libritts(config, subset):
    """One LibriTTS subset -> ``<raw_path>/<subset>/<speaker>/``; returns
    the number of utterances written."""
    in_dir = os.path.join(config["path"]["corpus_path"], subset)
    out_dir = os.path.join(config["path"]["raw_path"], subset)
    sr = config["preprocessing"]["audio"]["sampling_rate"]
    cleaners = config["preprocessing"]["text"]["text_cleaners"]
    if not os.path.isdir(in_dir):
        return 0
    n = 0
    for speaker in _sorted_dirs(in_dir):
        for chapter in _sorted_dirs(os.path.join(in_dir, speaker)):
            ch_dir = os.path.join(in_dir, speaker, chapter)
            for fname in sorted(os.listdir(ch_dir)):
                if not fname.endswith(".wav"):
                    continue
                base = fname[:-4]
                text_path = os.path.join(ch_dir, f"{base}.normalized.txt")
                if not os.path.exists(text_path):
                    continue
                with open(text_path) as f:
                    text = _clean_text(f.readline().strip("\n"), cleaners)
                _write_utterance(out_dir, speaker, base, os.path.join(ch_dir, fname),
                                 text, sr)
                n += 1
    return n


def prepare_align_vctk(config):
    """VCTK -> ``<raw_path>/all/<speaker>/``: mic2 flacs (mic1 skipped) or
    wavs with ``txt/<speaker>/<base>.txt``; returns the number written."""
    corpus = config["path"]["corpus_path"]
    out_dir = os.path.join(config["path"]["raw_path"], "all")
    sr = config["preprocessing"]["audio"]["sampling_rate"]
    cleaners = config["preprocessing"]["text"]["text_cleaners"]
    wav_root = next((os.path.join(corpus, c) for c in ("wav48_silence_trimmed", "wav48", "wav")
                     if os.path.isdir(os.path.join(corpus, c))), None)
    if wav_root is None:
        return 0
    txt_root = os.path.join(corpus, "txt")
    n = 0
    for speaker in _sorted_dirs(wav_root):
        spk_dir = os.path.join(wav_root, speaker)
        for fname in sorted(os.listdir(spk_dir)):
            if fname.endswith(".wav"):
                base = fname[:-4]
            elif fname.endswith(".flac"):
                base = fname[:-5]
                if "_mic1" in base:
                    continue          # the reference takes the mic2 feed only
            else:
                continue
            base = base.replace("_mic2", "")
            txt = os.path.join(txt_root, speaker, f"{base}.txt")
            if not os.path.exists(txt):
                continue
            with open(txt) as f:
                text = _clean_text(f.readline().strip("\n"), cleaners)
            _write_utterance(out_dir, speaker, base, os.path.join(spk_dir, fname), text, sr)
            n += 1
    return n


def prepare_align(config):
    """The config's corpus (VCTK when its ``dataset`` names it, else the
    LibriTTS subsets of its train / val / test splits) -> ``raw_path``;
    returns the number of utterances written."""
    if "VCTK" in config["dataset"]:
        return prepare_align_vctk(config)
    subsets = set()
    for key in ("train", "val", "test"):
        v = config["subsets"].get(key)
        if v:
            subsets.update(expand_subsets(v))
    return sum(prepare_align_libritts(config, s) for s in sorted(subsets))


def main(argv=None):
    from ..config import load_preprocess_configs
    parser = argparse.ArgumentParser(prog="python -m metatts_torch.preprocess.prepare_align")
    parser.add_argument("config", nargs="+", help="preprocess YAML(s)")
    args = parser.parse_args(argv)
    for cfg in load_preprocess_configs(args.config):
        n = prepare_align(cfg)
        print(f"{cfg['dataset']}: wrote {n} utterances to {cfg['path']['raw_path']}")


if __name__ == "__main__":
    main()
