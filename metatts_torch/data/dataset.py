"""On-disk dataset over preprocessed .npy features.

Reads the artifact layout the preprocessor writes (identical to the
reference's, ``dataset.py:95-109``): metadata lines
``basename|speaker|{phones}|raw_text`` plus mel/pitch/energy/duration npy
dirs and speakers.json.  Samples are numpy dicts for ``collate_batch``.
"""

import json
import os

import numpy as np

from ..text import text_to_sequence


def _read_metadata(path):
    """(basenames, speakers, texts, raw_texts) of a metadata file."""
    cols = ([], [], [], [])
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip("\n")
            if line:
                n, s, t, r = line.split("|", 3)
                for col, v in zip(cols, (n, s, t, r)):
                    col.append(v)
    return cols


class TTSDataset:
    def __init__(self, filename, preprocess_config, spk_refer_wav=False):
        pp = preprocess_config
        self.preprocessed_path = pp["path"]["preprocessed_path"]
        self.cleaners = pp["preprocessing"]["text"]["text_cleaners"]
        self.lang_id = pp.get("lang_id", 0)
        self.spk_refer_wav = spk_refer_wav
        self.dataset_tag = pp.get("dataset", "corpus")

        self.basename, self.speaker, self.text, self.raw_text = _read_metadata(
            os.path.join(self.preprocessed_path, filename))
        with open(os.path.join(self.preprocessed_path, "speakers.json")) as f:
            self.speaker_map = json.load(f)
        self.has_representations = os.path.isdir(
            os.path.join(self.preprocessed_path, "representation"))

    def __len__(self):
        return len(self.text)

    def speaker_label(self, idx):
        """Episode grouping label (reference datamodules/utils.py:133-142)."""
        return f"{self.dataset_tag}_{self.lang_id}-spk_{self.speaker[idx]}"

    def _npy(self, sub, kind, idx):
        return np.load(os.path.join(
            self.preprocessed_path, sub,
            f"{self.speaker[idx]}-{kind}-{self.basename[idx]}.npy"))

    def __getitem__(self, idx):
        phone = np.asarray(
            text_to_sequence(self.text[idx], self.cleaners), np.int32)
        sample = {
            "id": self.basename[idx],
            "speaker": self.speaker_map[self.speaker[idx]],
            "text": phone,
            "raw_text": self.raw_text[idx],
            "mel": self._npy("mel", "mel", idx).astype(np.float32),
            "pitch": self._npy("pitch", "pitch", idx).astype(np.float32),
            "energy": self._npy("energy", "energy", idx).astype(np.float32),
            "duration": self._npy("duration", "duration", idx).astype(np.int32),
            "lang_id": self.lang_id,
        }
        if self.spk_refer_wav:
            sample["spk_ref_mel_slices"] = self._npy(
                "spk_ref_mel_slices", "mel", idx).astype(np.float32)
        if self.has_representations:
            sample["representation"] = self._npy(
                "representation", "representation", idx).astype(np.float32)
        return sample


class TextDataset:
    """Text-only synthesis inputs (reference ``dataset.py:201-250``)."""

    def __init__(self, filepath, preprocess_config):
        self.cleaners = preprocess_config["preprocessing"]["text"][
            "text_cleaners"]
        self.basename, self.speaker, self.text, self.raw_text = _read_metadata(
            filepath)
        sp_path = os.path.join(
            preprocess_config["path"]["preprocessed_path"], "speakers.json")
        self.speaker_map = {}
        if os.path.exists(sp_path):
            with open(sp_path) as f:
                self.speaker_map = json.load(f)

    def __len__(self):
        return len(self.text)

    def __getitem__(self, idx):
        return {
            "id": self.basename[idx],
            "speaker": self.speaker_map.get(self.speaker[idx], 0),
            "text": np.asarray(
                text_to_sequence(self.text[idx], self.cleaners), np.int32),
            "raw_text": self.raw_text[idx],
        }
