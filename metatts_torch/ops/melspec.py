"""Log-mel spectrogram and energy: the CUDA kernel of ``csrc/melspec.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``fused_mel_spectrogram`` (Pallas, ``ops/pallas/
melspec.py`` of the TPU package): reflect pad by n_fft/2, frames at
``hop`` (``T // hop + 1`` of them), a Hann-windowed real DFT, magnitude,
the Slaney mel product, ``log(max(mel, 1e-5))``, and the energy
``sqrt(sum of power)``, all in fp32.  It computes
``TacotronSTFT.mel_spectrogram``.  The plain version takes the DFT as
products against cos/sin bases; the kernel as a real FFT per frame (an
n_fft/2-point complex FFT of the packed samples and a split step) and the
mel product over each band's own bins, from the tables of
``_kernel_tables``.

On a CUDA tensor ``fused_mel_spectrogram`` launches the kernel (or raises
for what it does not take); on a CPU tensor it runs
``fused_mel_spectrogram_plain``.  ``fused_mel_spectrogram.launches`` counts
the launches.
"""

import ctypes

import numpy as np
import torch

from .stft import mel_filterbank, padded_window, reflect_pad

# the kernel's fixed shapes (csrc/melspec.cu)
N_FFTS = (256, 512, 1024, 2048)   # powers of two, M = n_fft/2 points a frame
THREADS = 256                     # a block: n_fft/16 threads per frame
MAX_MELS = 128
MAX_SMEM = 227 * 1024

_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mtts_melspec": (_I, [_C] * 6 + [_I] * 6 + [_C]),
    "mtts_melspec_error_string": (ctypes.c_char_p, [_I]),
}

_constants_cache = {}


def _put(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _constants(n_fft, win_length, sr, n_mels, fmin, fmax, device):
    """fp32 tensors on ``device``, built in float64 as the TPU kernel builds
    them: ``cos``/``sin`` (n_fft, cutoff) windowed DFT bases, ``mel``
    (cutoff, n_mels)."""
    key = (n_fft, win_length, sr, n_mels, fmin, fmax, str(device))
    c = _constants_cache.get(key)
    if c is None:
        fourier = np.fft.fft(np.eye(n_fft))
        cutoff = n_fft // 2 + 1
        window = padded_window(win_length, n_fft)
        cos_b = (np.real(fourier[:cutoff]) * window[None, :]).T   # (n_fft, cutoff)
        sin_b = (np.imag(fourier[:cutoff]) * window[None, :]).T
        c = {"cos": _put(cos_b, np.float32, device), "sin": _put(sin_b, np.float32, device),
             "mel": _put(mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T, np.float32,
                         device)}
        _constants_cache[key] = c
    return c


def compact_filterbank(fb):
    """(n_mels, cutoff) filterbank -> (bands (n_mels, 3) int32: first bin,
    bin count, offset into weights; weights fp32, each band's run of bins
    from its first to its last nonzero weight).  An empty band has count 0."""
    bands, weights = np.zeros((fb.shape[0], 3), np.int32), []
    offset = 0
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        if len(nz):
            run = row[nz[0]:nz[-1] + 1]
            bands[m] = nz[0], len(run), offset
            weights.append(run)
            offset += len(run)
        else:
            bands[m] = 0, 0, offset
    return bands, (np.concatenate(weights) if weights else np.zeros(1)).astype(np.float32)


def _kernel_tables(n_fft, win_length, sr, n_mels, fmin, fmax, device):
    """What the kernel reads, built in float64 and cast once to fp32:
    ``tables`` = M = n_fft/2 complex twiddles W_M^t of the FFT passes, M
    complex W_N^k of the split step (interleaved re, im), then the padded
    Hann window; ``bands`` and ``weights`` from ``compact_filterbank``."""
    key = ("kernel", n_fft, win_length, sr, n_mels, fmin, fmax, str(device))
    c = _constants_cache.get(key)
    if c is None:
        half = n_fft // 2
        t = np.arange(half)
        tw = np.concatenate([np.exp(-2j * np.pi * t / half), np.exp(-2j * np.pi * t / n_fft)])
        tables = np.concatenate([np.stack([tw.real, tw.imag], 1).ravel(),
                                 padded_window(win_length, n_fft)])
        bands, weights = compact_filterbank(mel_filterbank(sr, n_fft, n_mels, fmin, fmax))
        c = {"tables": _put(tables, np.float32, device),
             "bands": _put(bands, np.int32, device),
             "weights": _put(weights, np.float32, device)}
        _constants_cache[key] = c
    return c


def fused_mel_spectrogram_plain(y, *, n_fft=1024, hop=256, win_length=1024,
                                sr=22050, n_mels=80, fmin=0.0, fmax=None):
    """Plain PyTorch version: (B, T) wav in [-1, 1] -> (log-mel (B, n_mels,
    frames), energy (B, frames)), fp32 products throughout."""
    c = _constants(n_fft, win_length, sr, n_mels, fmin, fmax, y.device)
    frames = reflect_pad(y.float(), n_fft // 2).unfold(-1, n_fft, hop)
    real = frames @ c["cos"]                                   # (B, F, cutoff)
    imag = frames @ c["sin"]
    power = real * real + imag * imag
    mel = torch.sqrt(power) @ c["mel"]                          # (B, F, n_mels)
    return (torch.log(torch.clamp(mel, min=1e-5)).transpose(1, 2),
            torch.sqrt(power.sum(-1)))


def kernel_shape_error(n_fft, hop, win_length, n_mels):
    """Why the CUDA kernel cannot take these parameters, or None."""
    if n_fft not in N_FFTS:
        return f"n_fft={n_fft} (a power of two from {N_FFTS[0]} to {N_FFTS[-1]})"
    if hop < 1:
        return f"hop={hop} (at least 1)"
    if win_length > n_fft:
        return f"win_length={win_length} > n_fft={n_fft}"
    if not 1 <= n_mels <= MAX_MELS:
        return f"n_mels={n_mels} (1 to {MAX_MELS})"
    # shared memory (csrc/melspec.cu, launch): twiddles and window 3 n_fft,
    # FFT buffers, energy partials, the audio span, log-mel staging, the
    # compact filterbank (at most n_fft + 2 weights: a bin is in two bands)
    half, frames = n_fft // 2, THREADS * 16 // n_fft
    floats = (3 * n_fft + frames * 2 * (half + half // 8) + 4 * frames
              + (frames - 1) * hop + n_fft + n_mels * (frames + 3) + n_fft + 2)
    if 4 * floats > MAX_SMEM:
        return f"hop={hop}, n_fft={n_fft}: a block needs {4 * floats} bytes of shared memory"
    return None


def _lib():
    from . import _build
    return _build.load("melspec", _SIGNATURES)


def fused_mel_spectrogram(y, *, n_fft=1024, hop=256, win_length=1024,
                          sr=22050, n_mels=80, fmin=0.0, fmax=None):
    """(B, T) fp32 wav -> (log-mel (B, n_mels, frames), energy (B, frames)).
    The kernel on a CUDA tensor (a ValueError for what it does not take),
    the plain version on a CPU tensor."""
    kw = dict(n_fft=n_fft, hop=hop, win_length=win_length, sr=sr,
              n_mels=n_mels, fmin=fmin, fmax=fmax)
    if y.device.type == "cpu":
        return fused_mel_spectrogram_plain(y, **kw)
    name = "fused_mel_spectrogram"
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    if y.dim() != 2 or y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError(f"{name}: y must be a contiguous fp32 (B, T) tensor, got "
                         f"{y.dtype} {tuple(y.shape)}")
    B, T = y.shape
    why = kernel_shape_error(n_fft, hop, win_length, n_mels)
    if why:
        raise ValueError(f"{name}: the CUDA kernel does not take {why}")
    if T < 1:
        raise ValueError(f"{name}: an empty waveform has no frames to pad")
    n_frames = T // hop + 1
    mel = torch.empty(B, n_mels, n_frames, dtype=torch.float32, device=y.device)
    energy = torch.empty(B, n_frames, dtype=torch.float32, device=y.device)
    if B == 0:
        return mel, energy
    c = _kernel_tables(n_fft, win_length, sr, n_mels, fmin, fmax, y.device)
    lib = _lib()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.mtts_melspec(ptr(y), ptr(c["tables"]), ptr(c["bands"]), ptr(c["weights"]),
                           ptr(mel), ptr(energy), B, T, n_fft, hop, n_mels,
                           c["weights"].numel(),
                           ctypes.c_void_p(torch.cuda.current_stream(y.device).cuda_stream))
    if err:
        raise RuntimeError(f"{name}: CUDA error "
                           f"{lib.mtts_melspec_error_string(err).decode()}")
    fused_mel_spectrogram.launches += 1
    return mel, energy


fused_mel_spectrogram.launches = 0
