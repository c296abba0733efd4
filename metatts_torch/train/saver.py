"""Saver: CSV logs, synthesized audio and spectrogram figures.

Functional equivalent of the reference Saver callback
(``lightning/callbacks/saver.py:23-275``), writing the JAX package's tree:
train-loss CSV rows every log_step, per-task validation/test CSVs keyed by
task id, and ``result/<exp>/{figure,audio,csv}/<split>/step_<ckpt>/...``
with ``*.recon.wav`` / ``*.synth.wav`` and their figures (a ``.npy`` of the
mel where matplotlib is missing).
"""

import csv
import os

import numpy as np

from ..preprocess.audio_io import save_wav

CSV_COLUMNS = ["step", "total", "mel", "postnet_mel", "pitch", "energy",
               "duration"]


class Saver:
    def __init__(self, log_dir, result_dir, sampling_rate=22050,
                 max_wav_value=32768.0):
        self.log_dir = log_dir
        self.result_dir = result_dir
        self.sampling_rate = sampling_rate
        self.max_wav_value = max_wav_value
        os.makedirs(log_dir, exist_ok=True)
        os.makedirs(result_dir, exist_ok=True)
        self._train_csv = os.path.join(log_dir, "train.csv")

    def _dir(self, kind, split, ckpt_step, task_id=None):
        d = os.path.join(self.result_dir, kind, split, f"step_{ckpt_step}",
                         *([task_id] if task_id else []))
        os.makedirs(d, exist_ok=True)
        return d

    # ----------------------------------------------------------- scalars

    def log_train(self, step, losses):
        new = not os.path.exists(self._train_csv)
        with open(self._train_csv, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(CSV_COLUMNS)
            w.writerow([step] + [float(x) for x in losses])

    def log_task_csv(self, split, task_id, rows, ckpt_step="last"):
        """rows: list of (adapt_step, LossValues)."""
        path = os.path.join(self._dir("csv", split, ckpt_step), f"{task_id}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["ft_step"] + CSV_COLUMNS[1:])
            for s, losses in rows:
                w.writerow([s] + [float(x) for x in losses])
        return path

    # ----------------------------------------------------------- artifacts

    def save_audio(self, split, task_id, name, wav, ckpt_step="last"):
        path = os.path.join(self._dir("audio", split, ckpt_step, task_id),
                            f"{name}.wav")
        save_wav(path, wav, self.sampling_rate, self.max_wav_value)
        return path

    def save_track_figure(self, split, task_id, name, mel, pitch, energy,
                          ckpt_step="last"):
        """Dual-axis mel + pitch/energy figure into the figure tree -- the
        per-saving-step spectrogram the reference Saver writes alongside
        each test wav (``saver.py:130-194`` via ``utils/tools.py:217-267``).
        """
        path = os.path.join(self._dir("figure", split, ckpt_step, task_id),
                            f"{name}.png")
        try:
            from .synth_utils import plot_mel_with_tracks
            return plot_mel_with_tracks(mel, pitch, energy, path, title=name)
        except ImportError:
            np.save(path + ".npy", np.asarray(mel))
            return path + ".npy"

    def save_panel_figure(self, split, task_id, name, panels, titles=None,
                          ckpt_step="last"):
        """Multi-row spectrogram figure (e.g. synthesized vs ground truth --
        the reference validation figure, ``saver.py:96-105``).  ``panels``:
        list of ``(mel, pitch, energy)``."""
        path = os.path.join(self._dir("figure", split, ckpt_step, task_id),
                            f"{name}.png")
        try:
            from .synth_utils import plot_mel_panels
            return plot_mel_panels(panels, path, titles)
        except ImportError:
            np.save(path + ".npy", np.asarray(panels[0][0]))
            return path + ".npy"

    def save_mel_figure(self, split, task_id, name, mel, ckpt_step="last"):
        """mel: (T, n_mels). Saved as PNG via matplotlib (optional dep)."""
        path = os.path.join(self._dir("figure", split, ckpt_step, task_id),
                            f"{name}.png")
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            np.save(path + ".npy", mel)
            return path + ".npy"
        fig, ax = plt.subplots(figsize=(10, 3))
        ax.imshow(np.asarray(mel).T, origin="lower", aspect="auto",
                  interpolation="none")
        ax.set_xlabel("frames")
        ax.set_ylabel("mel bins")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
