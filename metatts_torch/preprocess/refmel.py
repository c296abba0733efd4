"""Speaker-reference mel slices (resemblyzer conventions).

The reference calls resemblyzer's ``preprocess_wav`` +
``wav_to_mel_spectrogram`` + ``compute_partial_slices``
(``preprocessor/preprocessor.py:265-277``) to produce the 40-mel partials the
GE2E d-vector encoder consumes.  Re-implemented here with the same
constants: 16 kHz, 25 ms / 10 ms mel frames, 40 channels, 160-frame
partials at rate 1.3, min_coverage 0.75, -30 dBFS normalization and simple
energy-based VAD trimming (resemblyzer uses webrtcvad; we approximate with
an energy gate — same smoothing window).

This is another STFT (n_fft 400, hop 160, no log) than the log-mel kernel's,
and it stays on the host in numpy, as in the TPU package.
"""

import numpy as np

from .audio_io import resample
from ..ops.stft import mel_filterbank, _hann_window

SAMPLING_RATE = 16000
MEL_WINDOW_LENGTH = 25   # ms
MEL_WINDOW_STEP = 10     # ms
MEL_N_CHANNELS = 40
PARTIALS_N_FRAMES = 160
AUDIO_NORM_TARGET_DBFS = -30
VAD_WINDOW_LENGTH = 30   # ms
VAD_MOVING_AVERAGE_WIDTH = 8


def normalize_volume(wav, target_dbfs=AUDIO_NORM_TARGET_DBFS):
    rms = np.sqrt(np.mean(wav ** 2) + 1e-12)
    dbfs_change = target_dbfs - 20 * np.log10(rms + 1e-12)
    return wav * (10 ** (dbfs_change / 20))


def trim_silence(wav, sr=SAMPLING_RATE):
    """Energy-gate VAD with the same windowing as resemblyzer's webrtcvad."""
    win = sr * VAD_WINDOW_LENGTH // 1000
    n = len(wav) // win
    if n == 0:
        return wav
    frames = wav[: n * win].reshape(n, win)
    rms = np.sqrt(np.mean(frames ** 2, axis=1) + 1e-12)
    db = 20 * np.log10(rms + 1e-12)
    active = db > (db.max() - 30.0)
    # moving average smoothing
    kernel = np.ones(VAD_MOVING_AVERAGE_WIDTH) / VAD_MOVING_AVERAGE_WIDTH
    smooth = np.convolve(active.astype(np.float32), kernel, mode="same")
    keep = np.repeat(smooth > 0.5, win)
    keep = np.pad(keep, (0, len(wav) - len(keep)), constant_values=False)
    return wav[keep] if keep.any() else wav


def preprocess_ref_wav(wav, source_sr):
    """resemblyzer.preprocess_wav equivalent: resample 16k, normalize, trim."""
    if source_sr != SAMPLING_RATE:
        wav = resample(wav, source_sr, SAMPLING_RATE)
    wav = normalize_volume(wav)
    return trim_silence(wav)


# samples in one 160-frame GE2E partial window (1.6 s @ 16 kHz)
PARTIAL_SAMPLES = PARTIALS_N_FRAMES * SAMPLING_RATE * MEL_WINDOW_STEP // 1000


def tile_to_min_length(wav, n_samples=PARTIAL_SAMPLES):
    """Loop audio shorter than one GE2E partial window instead of
    zero-padding it.

    The d-vector is the LSTM's FINAL hidden state; a zero-padded tail means
    the net reads ~100 silent steps after the speech and its state relaxes
    to the input-independent zero-input fixed point — measured to collapse
    every short utterance to the SAME embedding (same/diff-speaker cosines
    all 1.000, GE2E loss pinned at ln(N); tools/probe_ge2e_training.py).
    Timbre is stationary, so looping the waveform preserves speaker
    identity while keeping real signal under the readout.  Long audio is
    returned unchanged, so resemblyzer partial-slicing semantics are
    untouched where they are well-defined."""
    if len(wav) == 0:
        return np.zeros(n_samples, np.float32)
    if len(wav) >= n_samples:
        return wav
    reps = int(np.ceil(n_samples / len(wav)))
    return np.tile(wav, reps)[:n_samples]


_mel_cache = {}


def wav_to_mel40(wav):
    """(T,) 16k wav -> (frames, 40) mel spectrogram (resemblyzer layout)."""
    n_fft = int(SAMPLING_RATE * MEL_WINDOW_LENGTH / 1000)   # 400
    hop = int(SAMPLING_RATE * MEL_WINDOW_STEP / 1000)       # 160
    if "basis" not in _mel_cache:
        _mel_cache["basis"] = mel_filterbank(
            SAMPLING_RATE, n_fft, MEL_N_CHANNELS)
        _mel_cache["window"] = _hann_window(n_fft)
    if len(wav) < 2:
        return np.zeros((0, MEL_N_CHANNELS), np.float32)
    # center=True framing (librosa semantics resemblyzer relies on):
    # n_frames = 1 + len // hop
    wav = np.pad(wav, (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(wav) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = wav[idx] * _mel_cache["window"][None, :]
    mag = np.abs(np.fft.rfft(frames, axis=1))
    return (mag @ _mel_cache["basis"].T).astype(np.float32)


def compute_partial_slices(n_samples, rate=1.3, min_coverage=0.75):
    """resemblyzer.VoiceEncoder.compute_partial_slices port."""
    samples_per_frame = int(SAMPLING_RATE * MEL_WINDOW_STEP / 1000)
    n_frames = int(np.ceil((n_samples + 1) / samples_per_frame))
    frame_step = int(np.round(SAMPLING_RATE / rate / samples_per_frame))

    wav_slices, mel_slices = [], []
    steps = max(1, n_frames - PARTIALS_N_FRAMES + frame_step + 1)
    for i in range(0, steps, frame_step):
        mel_range = np.array([i, i + PARTIALS_N_FRAMES])
        wav_range = mel_range * samples_per_frame
        mel_slices.append(slice(*mel_range))
        wav_slices.append(slice(*wav_range))

    last_wav_range = wav_slices[-1]
    coverage = (n_samples - last_wav_range.start) / (
        last_wav_range.stop - last_wav_range.start)
    if coverage < min_coverage and len(mel_slices) > 1:
        mel_slices = mel_slices[:-1]
        wav_slices = wav_slices[:-1]
    return wav_slices, mel_slices


def ref_mel_slices(wav, source_sr):
    """Full pipeline: wav -> list of (160, 40) partial mels."""
    wav = preprocess_ref_wav(wav, source_sr)
    wav_slices, mel_slices = compute_partial_slices(len(wav))
    max_len = wav_slices[-1].stop
    if max_len >= len(wav):
        wav = np.pad(wav, (0, max_len - len(wav)))
    mel = wav_to_mel40(wav)
    return np.stack([mel[s] for s in mel_slices]) if mel_slices else \
        np.zeros((0, PARTIALS_N_FRAMES, MEL_N_CHANNELS), np.float32)
