"""F0 extraction for offline preprocessing.

The reference shells out to pyworld's C++ DIO + StoneMask
(``preprocessor/preprocessor.py:215-220``).  Here the primary path is the
native C++ extractor of the repository's shared ``csrc/world.cpp`` (with
``csrc/flac.cpp``), built with g++ into the port's ``csrc/build/`` at first
use and loaded via ctypes; a vectorized numpy YIN serves as fallback and as
the cross-check in tests.

Contract (matches pyworld.dio): ``extract_f0(wav, sr, frame_period_ms)``
returns f0 in Hz per frame, 0.0 at unvoiced frames, frame count
= floor(len/ (sr*period)) + 1.
"""

import ctypes

import numpy as np

_F0_FLOOR = 71.0
_F0_CEIL = 800.0
SOURCES = ("world.cpp", "flac.cpp")

_lib = None
_build_attempted = False


def _load_native():
    """The native library, built on the first call; None if g++ fails."""
    global _lib, _build_attempted
    if _lib is not None or _build_attempted:
        return _lib
    _build_attempted = True
    from ..ops import _build
    try:
        path = _build.build_host("world", SOURCES)
    except (OSError, RuntimeError) as e:
        print(f"[f0] native build unavailable: {e}")
        return None
    lib = ctypes.CDLL(path)
    lib.dio_stonemask.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    lib.dio_stonemask.restype = ctypes.c_int
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.flac_info.argtypes = [
        u8p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long)]
    lib.flac_info.restype = ctypes.c_int
    lib.flac_decode.argtypes = [
        u8p, ctypes.c_long, ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
    lib.flac_decode.restype = ctypes.c_long
    _lib = lib
    return lib


def f0_backend():
    """Which backend ``extract_f0(use_native=True)`` will use:
    'native-dio' (csrc/world.cpp) or 'numpy-yin' (fallback)."""
    return "native-dio" if _load_native() is not None else "numpy-yin"


def n_frames(n_samples, sr, frame_period_ms):
    hop = sr * frame_period_ms / 1000.0
    return int(n_samples / hop) + 1


def extract_f0(wav, sr, frame_period_ms, use_native=True):
    """wav float in [-1,1] -> (n_frames,) f0 Hz, 0 at unvoiced.

    ``use_native``: True tries the native library (built on first use)
    and falls back to numpy YIN; "require" raises instead of falling back;
    False forces the YIN fallback (the cross-check reference in tests)."""
    wav = np.ascontiguousarray(wav, dtype=np.float64)
    nf = n_frames(len(wav), sr, frame_period_ms)
    lib = _load_native() if use_native else None
    if lib is not None:
        out = np.zeros(nf, np.float64)
        ok = lib.dio_stonemask(
            wav.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(wav),
            int(sr), float(frame_period_ms), _F0_FLOOR, _F0_CEIL,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nf)
        if ok == 0:
            return out
        if use_native == "require":
            raise RuntimeError(f"native dio_stonemask failed (rc={ok})")
    if use_native == "require":
        raise RuntimeError("native F0 extractor required but building "
                           "csrc/world.cpp with g++ failed")
    return yin_f0(wav, sr, frame_period_ms)


def yin_f0(wav, sr, frame_period_ms, threshold=0.15):
    """Vectorized YIN (de Cheveigné & Kawahara 2002) with parabolic
    interpolation; numpy fallback for the native extractor."""
    hop = sr * frame_period_ms / 1000.0
    nf = n_frames(len(wav), sr, frame_period_ms)
    tau_min = max(2, int(sr / _F0_CEIL))
    tau_max = int(sr / _F0_FLOOR) + 1
    W = tau_max  # integration window

    need = tau_max + W + 1
    centers = (np.arange(nf) * hop).astype(np.int64)
    pad_w = np.pad(wav, (0, max(0, centers[-1] + need - len(wav))))

    # frames: (nf, W + tau_max + 1)
    idx = centers[:, None] + np.arange(need)[None, :]
    frames = pad_w[idx]

    # difference function d(tau) = sum_{t<W} (x[t] - x[t+tau])^2
    #                            = e0 + e_tau - 2 * r_W(tau)
    # r_W(tau) = sum_{t<W} x[t] x[t+tau]: cross-correlate x[0:W] with x.
    x = frames
    fft_len = 1
    while fft_len < 2 * need:
        fft_len *= 2
    head = np.zeros_like(x)
    head[:, :W] = x[:, :W]
    X_full = np.fft.rfft(x, fft_len, axis=1)
    X_head = np.fft.rfft(head, fft_len, axis=1)
    xcorr = np.fft.irfft(np.conj(X_head) * X_full, fft_len,
                         axis=1)[:, : tau_max + 1]
    # cumulative energies
    sq = x ** 2
    cs = np.cumsum(sq, axis=1)
    e0 = cs[:, W - 1]                          # energy of x[0:W]
    e_tau = cs[:, np.arange(tau_max + 1) + W - 1] - np.concatenate(
        [np.zeros((nf, 1)), cs[:, : tau_max]], axis=1)
    d = e0[:, None] + e_tau - 2 * xcorr
    d = np.maximum(d, 0.0)

    # cumulative mean normalized difference
    tau = np.arange(1, tau_max + 1)
    cmnd = np.ones((nf, tau_max + 1))
    csum = np.cumsum(d[:, 1:], axis=1)
    cmnd[:, 1:] = d[:, 1:] * tau[None, :] / np.maximum(csum, 1e-12)

    # first tau in [tau_min, tau_max] below threshold, else argmin
    region = cmnd[:, tau_min:tau_max + 1]
    below = region < threshold
    first = np.argmax(below, axis=1)
    has = below.any(axis=1)
    best = np.where(has, first, np.argmin(region, axis=1)) + tau_min

    # descend to the local minimum of the dip (first threshold crossing sits
    # on the falling slope; the true period is at the bottom)
    rows = np.arange(nf)
    for _ in range(64):
        nxt = np.clip(best + 1, 0, tau_max)
        take = cmnd[rows, nxt] < cmnd[rows, best]
        if not take.any():
            break
        best = np.where(take, nxt, best)

    # parabolic interpolation around best
    b = np.clip(best, tau_min + 1, tau_max - 1)
    y0 = cmnd[np.arange(nf), b - 1]
    y1 = cmnd[np.arange(nf), b]
    y2 = cmnd[np.arange(nf), b + 1]
    denom = y0 - 2 * y1 + y2
    offset = np.where(np.abs(denom) > 1e-12,
                      0.5 * (y0 - y2) / np.where(np.abs(denom) > 1e-12,
                                                 denom, 1.0),
                      0.0)
    offset = np.clip(offset, -1, 1)
    tau_est = b + offset

    f0 = sr / tau_est
    voiced = has & (cmnd[np.arange(nf), best] < 0.5) & (e0 > 1e-8)
    f0 = np.where(voiced, f0, 0.0)
    f0[(f0 < _F0_FLOOR) | (f0 > _F0_CEIL)] = 0.0
    return f0
