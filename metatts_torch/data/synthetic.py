"""Deterministic synthetic multi-speaker corpus with learnable speaker
structure (the JAX package's ``data/synthetic.py``), for the meta-vs-
baseline experiments of ``metatts_torch.experiments``.

Generative model (everything derives from one seed, through numpy's
``RandomState`` as in the JAX package, so both packages draw the same
arrays for the same seed and calls):

* a phone inventory with per-phone mel prototypes, base pitch, base energy
  and base durations: the speaker-independent structure every system can
  learn outright;
* per-speaker latents: a mel tilt added to every frame, a pitch offset, an
  energy offset and a duration rate, recoverable only from a speaker's own
  utterances.  Held-out speakers draw theirs from the same distribution, so
  few-shot adaptation has something real to absorb.

Utterances come out as ``data.collate.Batch``es of static shapes (L phones,
T mel frames), on the device the caller names, so ``System.train_step``
and ``System.test_adapt`` run on them unchanged.
"""

import numpy as np
import torch

from ..ops.stft import TacotronSTFT
from ..utils.tools import resolve_device
from .collate import Batch, stack_batches

# stats matching the latent distributions below (pitch / energy z-scores
# land in roughly [-4, 4]); they set the variance adaptor's bins
STATS = {"pitch": [-5.0, 5.0, 0.0, 1.0], "energy": [-5.0, 5.0, 0.0, 1.0]}


class SyntheticVoices:
    """A frozen universe of speakers and a deterministic utterance sampler.

    n_speakers: total speakers; callers split the ids into train and
    held-out sets.  vocab: phone inventory (ids 1..vocab; 0 stays the pad
    symbol).  L, T: static phone and mel-frame lengths (durations sum to at
    most T).  noise: per-utterance observation noise on mel, pitch and
    energy, so an episode's support and query sets differ.
    """

    def __init__(self, n_speakers, n_mels=8, vocab=40, L=16, T=48, seed=0,
                 noise=0.05, tilt_spread=0.8, pitch_spread=1.2,
                 energy_spread=0.8, dur_spread=0.3):
        rng = np.random.RandomState(seed)
        self.n_speakers, self.n_mels, self.vocab = n_speakers, n_mels, vocab
        self.L, self.T, self.noise = L, T, noise
        # speaker-independent phone structure
        self.proto = rng.randn(vocab + 1, n_mels).astype(np.float32)
        self.base_p = (rng.randn(vocab + 1) * 0.7).astype(np.float32)
        self.base_e = (rng.randn(vocab + 1) * 0.7).astype(np.float32)
        self.base_d = rng.randint(1, 3, size=vocab + 1)  # 1..2 frames
        # per-speaker latents (the few-shot target)
        self.tilt = (rng.randn(n_speakers, n_mels) * tilt_spread).astype(np.float32)
        self.pitch_off = (rng.randn(n_speakers) * pitch_spread).astype(np.float32)
        self.energy_off = (rng.randn(n_speakers) * energy_spread).astype(np.float32)
        self.dur_rate = (1.0 + rng.uniform(-dur_spread, dur_spread, n_speakers)
                         ).astype(np.float32)

    def utterance(self, speaker, rng):
        """One utterance of ``speaker`` as numpy arrays (no batch axis)."""
        phones = rng.randint(1, self.vocab + 1, size=self.L).astype(np.int32)
        d = np.maximum(1, np.round(
            self.base_d[phones] * self.dur_rate[speaker])).astype(np.int32)
        # base_d <= 2 and rate <= 1.3 give d <= 3; trim from the longest
        # should L * 3 ever exceed T
        while d.sum() > self.T:
            d[np.argmax(d)] -= 1
        total = int(d.sum())
        expanded = np.repeat(phones, d)
        mel = np.zeros((self.T, self.n_mels), np.float32)
        mel[:total] = (self.proto[expanded] + self.tilt[speaker]
                       + rng.randn(total, self.n_mels).astype(np.float32) * self.noise)
        pitch = (self.base_p[phones] + self.pitch_off[speaker]
                 + rng.randn(self.L).astype(np.float32) * self.noise)
        energy = (self.base_e[phones] + self.energy_off[speaker]
                  + rng.randn(self.L).astype(np.float32) * self.noise)
        return dict(phones=phones, d=d, mel=mel, mel_len=total,
                    pitch=pitch.astype(np.float32), energy=energy.astype(np.float32))

    def batch(self, speakers, rng, device="cpu"):
        """A flat Batch, one utterance per entry of ``speakers``, on
        ``device``."""
        utts = [self.utterance(s, rng) for s in speakers]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return Batch(
            speaker_args=t(np.asarray(speakers, np.int32)),
            texts=t(np.stack([u["phones"] for u in utts])),
            src_lens=t(np.full((len(utts),), self.L, np.int32)),
            mels=t(np.stack([u["mel"] for u in utts])),
            mel_lens=t(np.asarray([u["mel_len"] for u in utts], np.int32)),
            p_targets=t(np.stack([u["pitch"] for u in utts])),
            e_targets=t(np.stack([u["energy"] for u in utts])),
            d_targets=t(np.stack([u["d"] for u in utts])),
        )

    def episode(self, speaker, shots, queries, rng, device="cpu"):
        """(support, query) Batches of one speaker: a 1-way few-shot task."""
        sup = self.batch([speaker] * shots, rng, device)
        qry = self.batch([speaker] * queries, rng, device)
        return sup, qry

    def meta_batch(self, speakers, shots, queries, rng, device="cpu"):
        """(support, query) stacked on a leading episode axis E =
        len(speakers)."""
        eps = [self.episode(s, shots, queries, rng, device) for s in speakers]
        return (stack_batches([e[0] for e in eps]),
                stack_batches([e[1] for e in eps]))


class SyntheticMelVocoder:
    """Griffin-Lim pseudo-vocoder for the synthetic corpus.

    Treats the n_mels-channel features as log-compressed mel magnitudes,
    lifts them to a linear-frequency magnitude spectrogram through the
    non-negative pseudo-inverse of the ``TacotronSTFT`` mel basis and
    recovers the phase by Griffin-Lim (``ops/stft.py``).  A speaker's mel
    tilt becomes a spectral envelope in the audio, so speaker identity
    survives the wav -> 40-mel -> d-vector round trip of the EER experiment.
    The defaults give a T=48-frame utterance ~1.5 s, one 160-frame GE2E
    partial after the 16 kHz frontend.

    The initial phases come from a CPU ``torch.Generator`` seeded with
    ``seed`` on every call (``TacotronSTFT.griffin_lim``), as the JAX
    package draws them from one fixed key; ``__call__`` also takes them
    explicitly through ``angles``.  Everything runs on ``device``
    (default the card; without one it raises unless ``device="cpu"``).
    """

    def __init__(self, n_mels=8, sr=16000, n_fft=1024, hop=512, n_iters=24,
                 seed=0, device="cuda"):
        self.device = resolve_device(device)
        self.sr, self.hop, self.n_iters, self.seed = sr, hop, n_iters, seed
        self.stft = TacotronSTFT(
            filter_length=n_fft, hop_length=hop, win_length=n_fft,
            n_mel_channels=n_mels, sampling_rate=sr, mel_fmin=0.0,
            mel_fmax=sr / 2.0, device=self.device)
        # (n_bins, n_mels) non-negative lift of the Slaney filterbank
        basis = self.stft.mel_basis.detach().cpu().numpy()
        self._inv = torch.from_numpy(
            np.maximum(np.linalg.pinv(basis), 0.0).astype(np.float32)).to(self.device)

    def magnitudes(self, mels):
        """(B, T, n_mels) log-mel features (array or tensor) -> (B, n_bins,
        T) linear magnitudes on ``device``: the clipped exponential through
        the lift."""
        if not isinstance(mels, torch.Tensor):
            mels = torch.from_numpy(np.array(mels, np.float32))
        mels = mels.to(self.device, torch.float32)
        mag_mel = torch.exp(torch.clamp(mels, -10.0, 6.0))
        return torch.einsum("fm,btm->bft", self._inv, mag_mel)

    @torch.no_grad()
    def __call__(self, mels, mel_lens=None, angles=None):
        """(B, T, n_mels) log-mel features -> list of B float32 numpy wavs,
        peak-normalised to 0.9; ``mel_lens`` trims each wav to its frames;
        ``angles`` (B, n_bins, T) replaces the seeded starting phases."""
        mags = self.magnitudes(mels)
        if angles is None:
            wavs = self.stft.griffin_lim(mags, self.n_iters, self.seed)
        else:
            wavs = self.stft._griffin_lim(mags, torch.as_tensor(np.array(angles)), self.n_iters)
        wavs = wavs.cpu().numpy()
        if isinstance(mel_lens, torch.Tensor):
            mel_lens = mel_lens.cpu().numpy()
        out = []
        for b, w in enumerate(wavs):
            if mel_lens is not None:
                w = w[: int(mel_lens[b]) * self.hop]
            peak = np.abs(w).max() if w.size else 0.0
            out.append((0.9 * w / peak if peak > 1e-8 else w).astype(np.float32))
        return out
