"""Offline evaluation harness (reference ``evaluation/main.py`` pipeline):

  wavs -> d-vectors (cached as .npy) -> centroid / pair similarity ->
  EER / DET / AUC -> txt reports.

Generic over the artifact tree the Saver writes (``train/saver.py``):
  <result_dir>/audio/Testing/step_<ckpt>/<task_id>/*.{recon,synth}.wav
plus a directory of real enrollment wavs per speaker.  The reference's
``evaluation/config.py`` hard-codes a Comet-experiment-key matrix of
mode -> result dir (31 modes x adaptation steps); here the same structure is
a plain dict argument.

The cache files (``<key>_dvector.npy``, ``<key>_names.json`` and the
result tree's md5 tag in the key) are named and filled as the TPU
package's harness names and fills them, so one cache directory serves
either package.
"""

import hashlib
import json
import os
import re

import numpy as np

from .dvector import DVectorEncoder
from .similarity import centroid_similarity, pair_similarity
from .verification import speaker_verification_eer
from ..preprocess.audio_io import load_wav


class EvaluationHarness:
    def __init__(self, cache_dir="eval_cache", weights_npz=None, device="cuda"):
        self.encoder = DVectorEncoder(weights_npz=weights_npz, device=device)
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    # ------------------------------------------------------------ embed

    def _embed_files(self, files, cache_key):
        cache = os.path.join(self.cache_dir, f"{cache_key}_dvector.npy")
        names_cache = os.path.join(self.cache_dir, f"{cache_key}_names.json")
        if os.path.exists(cache) and os.path.exists(names_cache):
            with open(names_cache) as f:
                cached_names = json.load(f)
            if cached_names == [os.path.basename(f) for f in files]:
                return np.load(cache)
        dvecs = []
        for f in files:
            wav, sr = load_wav(f)
            dvecs.append(self.encoder.embed_utterance(wav, sr))
        out = np.stack(dvecs) if dvecs else np.zeros((0, 256), np.float32)
        np.save(cache, out)
        with open(names_cache, "w") as f:
            json.dump([os.path.basename(f) for f in files], f)
        return out

    def embed_speaker_dirs(self, root, cache_key, max_per_speaker=None):
        """<root>/<speaker>/*.wav -> dict speaker -> (N, 256)."""
        out = {}
        for spk in sorted(os.listdir(root)):
            d = os.path.join(root, spk)
            if not os.path.isdir(d):
                continue
            files = sorted(os.path.join(d, f) for f in os.listdir(d)
                           if f.endswith(".wav"))
            if max_per_speaker:
                files = files[:max_per_speaker]
            if files:
                out[spk] = self._embed_files(files, f"{cache_key}_{spk}")
        return out

    def embed_result_tree(self, result_dir, kind="synth", step="step_last",
                          ft_step=None):
        """Saver test tree -> dict task_id -> (N, 256).

        ``ft_step`` selects the synth wavs of one adaptation saving step
        (files named ``*-FTstep_<n>.synth.wav``) so EER can be computed per
        adaptation step from a single test run (reference eval matrix steps
        {0, 5, 10, 20, 50, 100}); None takes every matching wav.
        """
        root = os.path.join(result_dir, "audio", "Testing", step)
        out = {}
        if not os.path.isdir(root):
            return out
        # the cache key must identify the TREE, not just task/kind/ft:
        # different modes (meta vs baseline result dirs) share task names
        # AND wav basenames, so without a per-dir tag the second mode
        # evaluated silently reuses the first mode's cached d-vectors
        # (observed: meta == baseline in every EER row).
        dirtag = hashlib.md5(
            os.path.abspath(result_dir).encode()).hexdigest()[:8]
        for task in sorted(os.listdir(root)):
            d = os.path.join(root, task)
            if not os.path.isdir(d):
                continue
            files = sorted(os.path.join(d, f) for f in os.listdir(d)
                           if f.endswith(f".{kind}.wav"))
            if ft_step is not None:
                files = [f for f in files
                         if f"-FTstep_{ft_step}." in os.path.basename(f)]
            if files:
                key = (f"res_{dirtag}_"
                       f"{re.sub('[^A-Za-z0-9]', '_', task)}_{kind}")
                if ft_step is not None:
                    key += f"_ft{ft_step}"
                out[task] = self._embed_files(files, key)
        return out

    @staticmethod
    def regroup_by_speaker(task_groups, descriptions):
        """task_id ('test_NNN') -> speaker groups, via the frozen episode
        descriptions the datamodule persists (test_descriptions.json:
        ordered list of {label: '<corpus>-spk_<id>', ...}).  Same/different-
        speaker pairs then span tasks, which is what the reference's
        per-speaker d-vector pools do (evaluation/wavs_to_dvector.py)."""
        out = {}
        for task, vecs in task_groups.items():
            try:
                # 1-shot sub-tasks are 'test_NNN_k' — the episode index is
                # the first numeric component after 'test_'
                idx = int(task.split("_")[1])
                label = descriptions[idx]["label"]
            except (ValueError, IndexError, KeyError):
                label = task
            # pool by the FULL label ('<corpus>_<lang>-spk_<id>'): distinct
            # corpora can reuse numeric speaker ids, and merging those pools
            # would corrupt the same/different-speaker pairs
            out.setdefault(label, []).append(vecs)
        return {k: np.concatenate(v) for k, v in out.items()}

    # ----------------------------------------------------------- metrics

    @staticmethod
    def eer_report(dvecs_by_speaker):
        """Same/diff-speaker EER over per-speaker d-vector groups."""
        same, diff = pair_similarity(dvecs_by_speaker)
        return speaker_verification_eer(same, diff)

    @staticmethod
    def similarity_to_enrollment(enroll_by_speaker, test_by_speaker):
        """Mean cosine of each speaker's test d-vectors to their enrollment
        centroid (reference centroid_similarity).

        Test pools are keyed by full episode label
        ('<corpus>_<lang>-spk_<id>'); enrollment dirs are usually named by
        bare speaker id, so a pool also matches the enrollment key that is
        its '-spk_' suffix (unambiguous: ids are unique within a corpus).
        """
        sims = {}
        for spk, vecs in test_by_speaker.items():
            key = spk if spk in enroll_by_speaker else \
                spk.split("-spk_", 1)[-1]
            if key in enroll_by_speaker:
                sims[spk] = float(np.mean(
                    centroid_similarity(enroll_by_speaker[key], vecs)))
        return sims

    @staticmethod
    def similarity_values(enroll_by_speaker, test_by_speaker):
        """Per-utterance cosine-to-enrollment-centroid values pooled over
        speakers — the distribution behind the reference's errorbar
        similarity plot (``evaluation/similarity_plot.py``); same key
        matching as similarity_to_enrollment."""
        vals = []
        for spk, vecs in test_by_speaker.items():
            key = spk if spk in enroll_by_speaker else \
                spk.split("-spk_", 1)[-1]
            if key in enroll_by_speaker:
                vals.append(np.asarray(
                    centroid_similarity(enroll_by_speaker[key], vecs)))
        return (np.concatenate(vals) if vals
                else np.zeros((0,), np.float32))

    def write_report(self, path, rows):
        """rows: list of (label, value) -> eer.txt-style report.

        When the encoder runs random-init (no pretrained GE2E weights),
        every line is tagged UNCALIBRATED so the numbers can never be
        mistaken for reference-comparable EER.
        """
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tag = "" if self.encoder.calibrated else "UNCALIBRATED\t"
        with open(path, "w") as f:
            if not self.encoder.calibrated:
                f.write("# UNCALIBRATED: random-init d-vector encoder — "
                        "values are not comparable to reference EER\n")
            for label, value in rows:
                f.write(f"{tag}{label}\t{value}\n")
        return path
