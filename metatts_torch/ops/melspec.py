"""Log-mel spectrogram and energy: the CUDA kernel of ``csrc/melspec.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``fused_mel_spectrogram`` (Pallas, ``ops/pallas/
melspec.py`` of the TPU package): reflect pad by n_fft/2, frames at
``hop`` (``T // hop + 1`` of them), a Hann-windowed real DFT as products
against cos/sin bases, magnitude, the Slaney mel product, ``log(max(mel,
1e-5))``, and the energy ``sqrt(sum of power)``, all in fp32.  It computes
``TacotronSTFT.mel_spectrogram``.

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
BIN_TILE = 64          # DFT bins per tile; bins [0, n_fft/2) in tiles, Nyquist apart
MAX_MELS = 80          # 16 threads x 5 mel bands per frame
FRAMES = 64            # frames per block
MAX_SMEM = 227 * 1024

_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mtts_melspec": (_I, [_C] * 6 + [_I] * 5 + [_C]),
    "mtts_melspec_error_string": (ctypes.c_char_p, [_I]),
}

_constants_cache = {}


def _constants(n_fft, win_length, sr, n_mels, fmin, fmax, device):
    """fp32 tensors on ``device``, built in float64 as the TPU kernel builds
    them: ``cos``/``sin`` (n_fft, cutoff) windowed DFT bases, ``mel``
    (cutoff, n_mels); for the kernel also ``tiles`` (n_fft/128, n_fft, 128)
    (per 64-bin tile, cos then sin columns) and ``nyquist`` (2, n_fft)."""
    key = (n_fft, win_length, sr, n_mels, fmin, fmax, str(device))
    c = _constants_cache.get(key)
    if c is None:
        fourier = np.fft.fft(np.eye(n_fft))
        cutoff = n_fft // 2 + 1
        window = padded_window(win_length, n_fft)
        cos_b = (np.real(fourier[:cutoff]) * window[None, :]).T   # (n_fft, cutoff)
        sin_b = (np.imag(fourier[:cutoff]) * window[None, :]).T
        half = n_fft // 2
        tiles = [np.concatenate([cos_b[:, t:t + BIN_TILE], sin_b[:, t:t + BIN_TILE]], 1)
                 for t in range(0, half - half % BIN_TILE, BIN_TILE)]
        put = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)).to(device)
        c = {"cos": put(cos_b), "sin": put(sin_b),
             "mel": put(mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T),
             "tiles": put(np.stack(tiles) if tiles else np.zeros((0, n_fft, 128))),
             "nyquist": put(np.stack([cos_b[:, half], sin_b[:, half]]))}
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
    if n_fft % 128 or n_fft < 128:
        return f"n_fft={n_fft} (a multiple of 128)"
    if hop % 32 or hop < 32:
        return f"hop={hop} (a multiple of 32)"
    if win_length > n_fft:
        return f"win_length={win_length} > n_fft={n_fft}"
    if not 1 <= n_mels <= MAX_MELS:
        return f"n_mels={n_mels} (1 to {MAX_MELS})"
    span = (FRAMES - 1) * hop + n_fft
    smem = 4 * (span + 4 * -(-span // 128) + 2 * 32 * 128 + FRAMES + 4)
    if smem > MAX_SMEM:
        return f"hop={hop}, n_fft={n_fft}: a block's audio span needs {smem} bytes"
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
    c = _constants(n_fft, win_length, sr, n_mels, fmin, fmax, y.device)
    lib = _lib()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.mtts_melspec(ptr(y), ptr(c["tiles"]), ptr(c["nyquist"]), ptr(c["mel"]),
                           ptr(mel), ptr(energy), B, T, n_fft, hop, n_mels,
                           ctypes.c_void_p(torch.cuda.current_stream(y.device).cuda_stream))
    if err:
        raise RuntimeError(f"{name}: CUDA error "
                           f"{lib.mtts_melspec_error_string(err).decode()}")
    fused_mel_spectrogram.launches += 1
    return mel, energy


fused_mel_spectrogram.launches = 0
