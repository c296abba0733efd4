"""STFT / mel-spectrogram / Griffin-Lim in PyTorch.

The STFT is a strided ``conv1d`` against the windowed real-DFT basis and the
inverse a ``conv_transpose1d`` plus the window-sumsquare normalisation, as
in the TPU package's ``ops/stft.py`` (the reference's ``audio/stft.py``).
The bases and the Slaney mel filterbank are built in float64 numpy exactly
as there, then cast once to fp32 and moved to the device given at
construction.

``TacotronSTFT.mel_spectrogram`` on a CUDA tensor is one launch of the
hand-written log-mel kernel (``ops/melspec.py``); on a CPU tensor it runs
the conv-DFT path below.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.tools import resolve_device


# ------------------------------------------------------------------ mel fb

def _hz_to_mel(f):
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


def mel_filterbank(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """(n_mels, n_fft//2+1) Slaney-normalized triangular mel filterbank,
    float32 (librosa.filters.mel(htk=False, norm='slaney'))."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _hann_window(win_length, fftbins=True):
    """Periodic Hann (scipy.signal.get_window('hann', N, fftbins=True)),
    float64."""
    n = np.arange(win_length)
    denom = win_length if fftbins else win_length - 1
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)).astype(np.float64)


def padded_window(win_length, n_fft):
    """The Hann window centred in n_fft samples (float64)."""
    window = _hann_window(win_length)
    if n_fft > win_length:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def dynamic_range_compression(x, C=1.0, clip_val=1e-5):
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x, C=1.0):
    """The inverse of ``dynamic_range_compression`` above its clip."""
    return torch.exp(x) / C


def reflect_pad(x, pad):
    """(..., T) -> (..., T + 2 pad) with numpy's ``mode="reflect"``,
    reflecting again where pad exceeds T - 1 (a gather, so exact)."""
    T = x.shape[-1]
    j = torch.arange(-pad, T + pad, device=x.device)
    if T == 1:
        idx = torch.zeros_like(j)
    else:
        period = 2 * (T - 1)
        m = torch.remainder(j, period)
        idx = torch.where(m >= T, period - m, m)
    return x[..., idx]


# ------------------------------------------------------------------ STFT

class TacotronSTFT:
    """STFT + mel projection with the reference's exact conventions.

    Holds the windowed DFT basis, the inverse basis and the mel basis as
    fp32 tensors on ``device`` (default ``"cuda"``, which must exist).
    Methods take (B, T) waveforms as tensors or numpy arrays and return
    tensors on ``device``.
    """

    def __init__(self, filter_length=1024, hop_length=256, win_length=1024,
                 n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
                 mel_fmax=None, device="cuda"):
        self.device = resolve_device(device)
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mel_channels = n_mel_channels
        self.sampling_rate = sampling_rate
        self.mel_fmin = mel_fmin
        self.mel_fmax = mel_fmax
        self.cutoff = filter_length // 2 + 1

        fourier = np.fft.fft(np.eye(filter_length))
        basis = np.vstack([np.real(fourier[: self.cutoff]),
                           np.imag(fourier[: self.cutoff])])
        window = padded_window(win_length, filter_length)
        scale = filter_length / hop_length
        put = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.device)
        self.forward_basis = put(basis * window[None, :])          # (2C, N)
        self.inverse_basis = put(np.linalg.pinv(scale * basis).T
                                 * window[None, :])                 # (2C, N)
        self.mel_basis = put(mel_filterbank(
            sampling_rate, filter_length, n_mel_channels, mel_fmin, mel_fmax))
        # the window-sumsquare envelope depends on the frame count: built on
        # the host per call, as in the TPU package
        self._win_sq = (window ** 2).astype(np.float32)

    def _tensor(self, y):
        return torch.as_tensor(y, dtype=torch.float32).to(self.device)

    # -- forward ---------------------------------------------------------

    def transform(self, y):
        """(B, T) waveform in [-1, 1] -> magnitude, phase each (B, cutoff, frames)."""
        x = reflect_pad(self._tensor(y), self.filter_length // 2)
        out = F.conv1d(x[:, None, :], self.forward_basis[:, None, :],
                       stride=self.hop_length)
        real = out[:, : self.cutoff]
        imag = out[:, self.cutoff :]
        return torch.sqrt(real ** 2 + imag ** 2), torch.atan2(imag, real)

    def mel_spectrogram(self, y):
        """(B, T) wav -> (log-mel (B, n_mels, frames), energy (B, frames)).

        Log-compressed Slaney mel and L2-over-frequency energy (reference
        ``audio/stft.py:159-178``).  On the card: one launch of the log-mel
        kernel.  On the CPU: the conv-DFT STFT, mel product, log clamp and
        the norm of the magnitudes.
        """
        y = self._tensor(y)
        if y.device.type == "cuda":
            from . import melspec
            return melspec.fused_mel_spectrogram(
                y, n_fft=self.filter_length, hop=self.hop_length,
                win_length=self.win_length, sr=self.sampling_rate,
                n_mels=self.n_mel_channels, fmin=self.mel_fmin,
                fmax=self.mel_fmax)
        magnitudes, _ = self.transform(y)
        mel = torch.einsum("mf,bft->bmt", self.mel_basis, magnitudes)
        return dynamic_range_compression(mel), torch.linalg.norm(magnitudes, dim=1)

    # -- inverse ---------------------------------------------------------

    def _window_sumsquare(self, n_frames):
        n = self.filter_length + self.hop_length * (n_frames - 1)
        x = np.zeros(n, dtype=np.float32)
        for i in range(n_frames):
            s = i * self.hop_length
            x[s : min(n, s + self.filter_length)] += self._win_sq[
                : max(0, min(self.filter_length, n - s))]
        return x

    def inverse(self, magnitude, phase):
        """ISTFT: overlap-add of inverse-basis frames (the reference's
        conv_transpose1d, ``audio/stft.py:84-122``) + window-sumsquare
        normalization.  (B, cutoff, frames) each -> (B, 1, samples)."""
        magnitude, phase = self._tensor(magnitude), self._tensor(phase)
        n_frames = magnitude.shape[-1]
        rec = torch.cat([magnitude * torch.cos(phase),
                         magnitude * torch.sin(phase)], dim=1)
        inv = F.conv_transpose1d(rec, self.inverse_basis[:, None, :],
                                 stride=self.hop_length)
        wss = self._window_sumsquare(n_frames)
        tiny = np.finfo(np.float32).tiny
        denom = np.where(wss > tiny, wss, 1.0).astype(np.float32)
        inv = inv / torch.from_numpy(denom).to(inv.device)[None, None, :]
        inv = inv * (self.filter_length / self.hop_length)
        pad = self.filter_length // 2
        return inv[:, :, pad:-pad]

    def griffin_lim(self, magnitudes, n_iters=60, seed=0):
        """Phase recovery by alternating projection (reference:
        ``audio/audio_processing.py:66-82``), from phases uniform in
        [-pi, pi) drawn by a CPU generator seeded with ``seed``."""
        gen = torch.Generator().manual_seed(seed)
        angles = torch.rand(tuple(magnitudes.shape), generator=gen)
        return self._griffin_lim(magnitudes, (2 * angles - 1) * math.pi,
                                 n_iters)

    def _griffin_lim(self, magnitudes, angles, n_iters):
        magnitudes = self._tensor(magnitudes)
        signal = self.inverse(magnitudes, angles)[:, 0]
        for _ in range(n_iters):
            _, angles = self.transform(signal)
            signal = self.inverse(magnitudes, angles)[:, 0]
        return signal
