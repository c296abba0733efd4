"""Offline preprocessing: raw corpus + MFA TextGrids -> per-utterance .npy
features + corpus metadata.

Artifact-compatible with the reference (``preprocessor/preprocessor.py``)
and, name for name and layout for layout, with the TPU package's
preprocessor:
  <out>/mel/<spk>-mel-<base>.npy            (T, n_mels) float32 (log-mel)
  <out>/pitch/<spk>-pitch-<base>.npy        phoneme- or frame-level, z-normed
  <out>/energy/<spk>-energy-<base>.npy      idem
  <out>/duration/<spk>-duration-<base>.npy  int frame counts per phone
  <out>/spk_ref_mel_slices/<spk>-mel-<base>.npy  (S, 160, 40)
  <out>/speakers.json  <out>/stats.json  <out>/<dset>.txt

Each utterance's log-mel and energy come from ``TacotronSTFT.
mel_spectrogram`` on ``device``: on the card that is one launch of the
log-mel kernel.  Everything else (wav reading, native F0, alignment,
reference slices, statistics, files) stays on the host.  Cross-corpus stats
sharing keeps the reference's "reuse existing stats.json" behavior
(``preprocessor.py:117-143``).
"""

import json
import os
import time

import numpy as np
import torch
from scipy.interpolate import interp1d

from ..ops.stft import TacotronSTFT
from .audio_io import load_wav
from .pitch import extract_f0, f0_backend
from .refmel import ref_mel_slices
from .textgrid import read_textgrid

SIL_PHONES = ["sil", "sp", "spn", ""]


class OnlineScaler:
    """Running mean/std (StandardScaler.partial_fit equivalent)."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def partial_fit(self, x):
        x = np.asarray(x, np.float64).ravel()
        if x.size == 0:
            return
        n_b = x.size
        mean_b = x.mean()
        m2_b = ((x - mean_b) ** 2).sum()
        delta = mean_b - self.mean
        n = self.n + n_b
        self.mean += delta * n_b / n
        self.m2 += m2_b + delta ** 2 * self.n * n_b / n
        self.n = n

    @property
    def std(self):
        return float(np.sqrt(self.m2 / self.n)) if self.n else 1.0


class Preprocessor:
    """``Preprocessor(config, device="cuda")``; the device must exist.

    ``seconds`` sums host-clock time per stage over the utterances
    processed: ``load`` (wav, TextGrid, text), ``f0``, ``mel`` (copy to the
    device, the mel call, copy back), ``ref`` (reference slices), ``save``.
    """

    def __init__(self, config, device="cuda"):
        self.config = config
        self.in_dir = config["path"]["raw_path"]
        self.out_dir = config["path"]["preprocessed_path"]
        pp = config["preprocessing"]
        self.val_size = pp["val_size"]
        self.sampling_rate = pp["audio"]["sampling_rate"]
        self.hop_length = pp["stft"]["hop_length"]
        self.pitch_phoneme_averaging = pp["pitch"]["feature"] == "phoneme_level"
        self.energy_phoneme_averaging = pp["energy"]["feature"] == "phoneme_level"
        self.pitch_normalization = pp["pitch"]["normalization"]
        self.energy_normalization = pp["energy"]["normalization"]
        self.emit_representations = pp.get("representation", {}).get(
            "enabled", False)
        self.stft = TacotronSTFT(
            pp["stft"]["filter_length"], pp["stft"]["hop_length"],
            pp["stft"]["win_length"], pp["mel"]["n_mel_channels"],
            pp["audio"]["sampling_rate"], pp["mel"]["mel_fmin"],
            pp["mel"]["mel_fmax"], device=device)
        self.device = self.stft.device
        self.seconds = dict.fromkeys(("load", "f0", "mel", "ref", "save"), 0.0)
        subsets = config.get("subsets", {})
        self.sets = []
        for key in ("train", "val", "test"):
            v = subsets.get(key)
            if v is None:
                continue
            vs = v if isinstance(v, list) else [v]
            for s in vs:
                if s not in self.sets:
                    self.sets.append(s)

    # ----------------------------------------------------------- corpus

    def build_from_path(self):
        # which F0 extractor actually runs (the reference's pyworld C++ is
        # replaced by the native csrc/world.cpp; numpy YIN is only a fallback)
        print(f"[f0] backend: {f0_backend()}")
        subs = ["mel", "pitch", "energy", "duration", "spk_ref_mel_slices"]
        if self.emit_representations:
            subs.append("representation")
        for sub in subs:
            os.makedirs(os.path.join(self.out_dir, sub), exist_ok=True)

        pitch_scaler, energy_scaler = OnlineScaler(), OnlineScaler()
        speakers, outs = {}, {}
        i = 0
        for dset in self.sets:
            dset_dir = os.path.join(self.in_dir, dset)
            out = []
            if not os.path.isdir(dset_dir):
                outs[dset] = out
                continue
            for speaker in sorted(os.listdir(dset_dir)):
                if not os.path.isdir(os.path.join(dset_dir, speaker)):
                    continue
                speakers[speaker] = i
                for wav_name in sorted(os.listdir(
                        os.path.join(dset_dir, speaker))):
                    if not wav_name.endswith(".wav"):
                        continue
                    basename = wav_name[: -len(".wav")]
                    tg_path = os.path.join(self.out_dir, "TextGrid", speaker,
                                           f"{basename}.TextGrid")
                    if not os.path.exists(tg_path):
                        continue
                    ret = self.process_utterance(dset_dir, speaker, basename)
                    if ret is None:
                        continue
                    info, pitch, energy, _ = ret
                    out.append(info)
                    if len(pitch):
                        pitch_scaler.partial_fit(pitch)
                    if len(energy):
                        energy_scaler.partial_fit(energy)
                i += 1
            outs[dset] = out

        # stats: reuse an existing stats.json (cross-corpus normalization)
        stats_path = os.path.join(self.out_dir, "stats.json")
        prev = None
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                prev = json.load(f)
        pitch_mean, pitch_std = self._stats(
            self.pitch_normalization, prev and prev["pitch"], pitch_scaler)
        energy_mean, energy_std = self._stats(
            self.energy_normalization, prev and prev["energy"], energy_scaler)

        pitch_min, pitch_max = self._normalize_dir("pitch", pitch_mean,
                                                   pitch_std)
        energy_min, energy_max = self._normalize_dir("energy", energy_mean,
                                                     energy_std)

        with open(os.path.join(self.out_dir, "speakers.json"), "w") as f:
            json.dump(speakers, f)
        with open(stats_path, "w") as f:
            json.dump({
                "pitch": [float(pitch_min), float(pitch_max),
                          float(pitch_mean), float(pitch_std)],
                "energy": [float(energy_min), float(energy_max),
                           float(energy_mean), float(energy_std)],
            }, f)
        for dset, out in outs.items():
            with open(os.path.join(self.out_dir, f"{dset}.txt"), "w",
                      encoding="utf-8") as f:
                f.write("\n".join(out) + ("\n" if out else ""))
        return outs

    @staticmethod
    def _stats(normalize, prev, scaler):
        """(mean, std): an existing stats.json's entry first, else this
        corpus's; (0, 1) without normalization."""
        if not normalize:
            return 0.0, 1.0
        if prev is not None:
            return prev[2], prev[3]
        return scaler.mean, scaler.std

    # ------------------------------------------------------ per utterance

    def process_utterance(self, in_dir, speaker, basename,
                          with_ref_mels=True):
        t0 = time.perf_counter()
        wav_path = os.path.join(in_dir, speaker, f"{basename}.wav")
        text_path = os.path.join(in_dir, speaker, f"{basename}.lab")
        tg_path = os.path.join(self.out_dir, "TextGrid", speaker,
                               f"{basename}.TextGrid")

        tg = read_textgrid(tg_path)
        phones, durations, start, end = self.get_alignment(
            tg.get_tier_by_name("phones"))
        if start >= end or not phones:
            return None
        text = "{" + " ".join(phones) + "}"

        wav, _ = load_wav(wav_path, target_sr=self.sampling_rate)
        full_wav = wav
        wav = wav[int(self.sampling_rate * start):
                  int(self.sampling_rate * end)].astype(np.float32)
        if len(wav) == 0:
            return None

        raw_text = ""
        if os.path.exists(text_path):
            with open(text_path) as f:
                raw_text = f.readline().strip("\n")
        t1 = time.perf_counter()

        total = sum(durations)
        pitch = extract_f0(wav, self.sampling_rate,
                           self.hop_length / self.sampling_rate * 1000)
        pitch = pitch[:total]
        t2 = time.perf_counter()
        self.seconds["load"] += t1 - t0
        self.seconds["f0"] += t2 - t1
        if np.sum(pitch != 0) <= 1:
            return None

        y = torch.from_numpy(np.clip(wav, -1, 1)[None].astype(np.float32))
        mel, energy = self.stft.mel_spectrogram(y.to(self.device))
        mel = np.ascontiguousarray(mel[0].cpu().numpy())[:, :total]  # (n_mels, T)
        energy = energy[0].cpu().numpy()[:total]
        t3 = time.perf_counter()

        if self.pitch_phoneme_averaging:
            pitch = self._interp_unvoiced(pitch)
            pitch = self._phoneme_average(pitch, durations)
        if self.energy_phoneme_averaging:
            energy = self._phoneme_average(energy, durations)

        if with_ref_mels:
            slices = ref_mel_slices(full_wav, self.sampling_rate)
        else:
            slices = np.zeros((0, 160, 40), np.float32)
        t4 = time.perf_counter()

        def save(sub, kind, arr):
            np.save(os.path.join(self.out_dir, sub,
                                 f"{speaker}-{kind}-{basename}.npy"), arr)

        if self.emit_representations:
            # per-phoneme acoustic representations for the cross-lingual
            # codebook: the phoneme-averaged log-mel, an interface-compatible
            # stand-in for precomputed SSL features
            rep = np.zeros((len(durations), mel.shape[0]), np.float32)
            pos = 0
            for i, dur in enumerate(durations):
                if dur > 0:
                    rep[i] = mel[:, pos: pos + dur].mean(axis=1)
                pos += dur
            save("representation", "representation", rep)

        save("duration", "duration", np.asarray(durations, np.int64))
        save("pitch", "pitch", pitch)
        save("energy", "energy", energy)
        save("mel", "mel", mel.T)
        np.save(os.path.join(self.out_dir, "spk_ref_mel_slices",
                             f"{speaker}-mel-{basename}.npy"), slices)
        t5 = time.perf_counter()
        self.seconds["mel"] += t3 - t2
        self.seconds["ref"] += t4 - t3
        self.seconds["save"] += t5 - t4

        return ("|".join([basename, speaker, text, raw_text]),
                self._remove_outlier(pitch),
                self._remove_outlier(energy),
                mel.shape[1])

    def get_alignment(self, tier):
        """Trim leading/trailing silences; per-phone frame durations
        (reference ``preprocessor.py:308-346``; '' counts as silence — MFA2
        emits empty labels)."""
        phones, durations = [], []
        start_time = end_time = 0.0
        end_idx = 0
        for iv in tier.get_intervals():
            s, e, p = iv.start_time, iv.end_time, iv.text
            if not phones:
                if p in SIL_PHONES:
                    continue
                start_time = s
            if p not in SIL_PHONES:
                phones.append(p)
                end_time = e
                end_idx = len(phones)
            else:
                phones.append("sp")
            durations.append(
                int(np.round(e * self.sampling_rate / self.hop_length)
                    - np.round(s * self.sampling_rate / self.hop_length)))
        return phones[:end_idx], durations[:end_idx], start_time, end_time

    # ------------------------------------------------------------- utils

    @staticmethod
    def _interp_unvoiced(pitch):
        nz = np.where(pitch != 0)[0]
        if len(nz) < 2:
            return pitch
        fn = interp1d(nz, pitch[nz],
                      fill_value=(pitch[nz[0]], pitch[nz[-1]]),
                      bounds_error=False)
        return fn(np.arange(len(pitch)))

    @staticmethod
    def _phoneme_average(values, durations):
        out = np.zeros(len(durations), dtype=np.float64)
        pos = 0
        for i, d in enumerate(durations):
            out[i] = np.mean(values[pos: pos + d]) if d > 0 else 0.0
            pos += d
        return out.astype(np.float32)

    @staticmethod
    def _remove_outlier(values):
        values = np.asarray(values)
        if values.size == 0:
            return values
        p25, p75 = np.percentile(values, [25, 75])
        lower = p25 - 1.5 * (p75 - p25)
        upper = p75 + 1.5 * (p75 - p25)
        return values[(values > lower) & (values < upper)]

    def _normalize_dir(self, sub, mean, std):
        d = os.path.join(self.out_dir, sub)
        mx, mn = np.finfo(np.float64).min, np.finfo(np.float64).max
        for name in os.listdir(d):
            p = os.path.join(d, name)
            v = (np.load(p) - mean) / std
            np.save(p, v)
            if v.size:
                mx = max(mx, float(v.max()))
                mn = min(mn, float(v.min()))
        return mn, mx
