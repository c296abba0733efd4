"""Audio IO + resampling (replaces librosa.load / scipy write in the
reference).

Wav via scipy; FLAC via the native decoder built from the repository's
shared ``csrc/flac.cpp`` (the reference reads VCTK mic2 flac through
librosa/soundfile, ``preprocessor/vctk.py:11-46``).
"""

import ctypes
from math import gcd

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path, target_sr=None):
    """Read a wav or flac -> (float32 in [-1, 1], sr), resampling if asked."""
    if str(path).lower().endswith(".flac"):
        return load_flac(path, target_sr=target_sr)
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        x = resample(x, sr, target_sr)
        sr = target_sr
    return x, sr


def _flac_lib():
    from .pitch import _load_native
    lib = _load_native()
    if lib is None:
        raise RuntimeError("native FLAC decoder unavailable: building "
                           "csrc/flac.cpp with g++ failed")
    return lib


def load_flac(path, target_sr=None):
    """Decode a FLAC file natively -> (float32 mono in [-1, 1], sr)."""
    lib = _flac_lib()
    data = np.fromfile(path, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    bps = ctypes.c_int()
    tot = ctypes.c_long()
    if lib.flac_info(data.ctypes.data_as(u8p), len(data),
                     ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(bps),
                     ctypes.byref(tot)) != 0:
        raise ValueError(f"not a FLAC stream: {path}")
    # STREAMINFO may leave total_samples unknown (0): start from the
    # compression-free sample count and grow if the decoder fills the
    # buffer (flac_decode truncates at max_samples rather than erroring,
    # and well-compressed streams decode to MORE samples than len*8/bps)
    known = tot.value * ch.value
    max_samples = known or int(len(data) * 8 / max(bps.value, 1)) + 65536
    while True:
        out = np.zeros(max_samples, np.int32)
        n = lib.flac_decode(
            data.ctypes.data_as(u8p), len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_samples)
        if n < 0:
            raise ValueError(f"FLAC decode error {n}: {path}")
        if known or n < max_samples:
            break
        max_samples *= 2
    x = out[:n].astype(np.float32)
    if ch.value > 1:
        x = x.reshape(-1, ch.value).mean(axis=1)
    x = x / float(1 << (bps.value - 1))
    rate = sr.value
    if target_sr is not None and rate != target_sr:
        x = resample(x, rate, target_sr)
        rate = target_sr
    return x.astype(np.float32), rate


def resample(x, sr, target_sr):
    g = gcd(int(sr), int(target_sr))
    return resample_poly(x, target_sr // g, sr // g).astype(np.float32)


def save_wav(path, x, sr, max_wav_value=32768.0):
    """float [-1,1] -> int16 wav (reference convention, utils/model.py:48)."""
    x = np.asarray(x)
    if x.dtype.kind == "f":
        x = np.clip(x, -1.0, 1.0)
        x = (x * (max_wav_value - 1)).astype(np.int16)
    wavfile.write(path, sr, x)
