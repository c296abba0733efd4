"""Port: the log-mel kernel's plain version and the port's ``TacotronSTFT``
against the TPU package.

* ``fused_mel_spectrogram_plain`` against the Pallas kernel in interpret
  mode and against ``TacotronSTFT.mel_spectrogram`` at (2, 22050), with the
  Pallas test's tolerances (log-mel atol 1e-4, energy rtol and atol 1e-4);
  silence gives log(1e-5); a 300-sample input, shorter than the n_fft/2
  reflect pad, takes the repeated reflection;
* the port's ``TacotronSTFT`` (``transform``, ``mel_spectrogram``,
  ``inverse``, Griffin-Lim from the same phases) and its mel filterbank and
  window against the TPU package's.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there); on a CPU tensor the wrapper runs the
plain version, which is what these tests reach.  What the kernel reads is
built on the host and checked here: the compact filterbank rebuilds the
dense one, and a numpy emulation of the kernel's decomposition (a packed
n_fft/2-point Stockham FFT in the kernel's radices with the wrapper's fp32
twiddles, the split step, the sparse mel product) matches ``np.fft.rfft``
and the plain version.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from metatts_tpu.ops.pallas.melspec import fused_mel_spectrogram as jax_fused
from metatts_tpu.ops import stft as jstft
from metatts_torch.ops import stft as tstft
from metatts_torch.ops.melspec import (_kernel_tables, compact_filterbank,
                                       fused_mel_spectrogram,
                                       fused_mel_spectrogram_plain,
                                       kernel_shape_error)

from torch_port_helpers import one_torch_thread  # noqa: F401

MEL_ATOL = 1e-4          # tests/test_pallas_melspec.py
EN_TOL = 1e-4


@pytest.fixture(scope="module")
def jax_stft():
    return jstft.TacotronSTFT()


@pytest.fixture(scope="module")
def port_stft():
    return tstft.TacotronSTFT(device="cpu")


@pytest.fixture(scope="module")
def noise(jax_stft):
    y = np.random.RandomState(0).uniform(-0.8, 0.8, (2, 22050)).astype(np.float32)
    pallas = [np.asarray(a) for a in jax_fused(y, interpret=True)]
    xla = [np.asarray(a) for a in jax_stft.mel_spectrogram(y)]
    plain = [a.numpy() for a in fused_mel_spectrogram_plain(torch.from_numpy(y))]
    return y, pallas, xla, plain


def _close(got, ref):
    np.testing.assert_allclose(got[0], ref[0], atol=MEL_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], rtol=EN_TOL, atol=EN_TOL)


@pytest.mark.parametrize("ref", ["pallas_interpret", "tacotron_stft"])
def test_plain_matches_tpu_package(noise, ref):
    _, pallas, xla, plain = noise
    target = pallas if ref == "pallas_interpret" else xla
    assert plain[0].shape == (2, 80, 22050 // 256 + 1)
    assert plain[1].shape == (2, 22050 // 256 + 1)
    _close(plain, target)


def test_plain_silence():
    mel, en = fused_mel_spectrogram_plain(torch.zeros(1, 1000))
    assert mel.shape == (1, 80, 1000 // 256 + 1)
    np.testing.assert_allclose(mel.numpy(), np.log(1e-5), atol=1e-5, rtol=0)
    assert float(en.abs().max()) == 0.0


def test_short_input_repeated_reflection(jax_stft, port_stft):
    y = np.random.RandomState(1).uniform(-0.8, 0.8, (1, 300)).astype(np.float32)
    ref = [np.asarray(a) for a in jax_stft.mel_spectrogram(y)]
    assert ref[0].shape == (1, 80, 2)
    _close([a.numpy() for a in fused_mel_spectrogram_plain(torch.from_numpy(y))], ref)
    _close([a.numpy() for a in port_stft.mel_spectrogram(y)], ref)


@pytest.mark.parametrize("T", [1, 2, 5, 300, 2000])
def test_reflect_pad_is_numpys(T):
    y = np.random.RandomState(T).randn(2, T).astype(np.float32)
    got = tstft.reflect_pad(torch.from_numpy(y), 512).numpy()
    ref = np.pad(y, ((0, 0), (512, 512)), mode="reflect")
    np.testing.assert_array_equal(got, ref)


def test_wrapper_runs_plain_version_on_cpu(noise):
    y, _, _, plain = noise
    before = fused_mel_spectrogram.launches
    mel, en = fused_mel_spectrogram(torch.from_numpy(y))
    assert np.array_equal(mel.numpy(), plain[0])
    assert np.array_equal(en.numpy(), plain[1])
    assert fused_mel_spectrogram.launches == before        # no kernel launched


@pytest.mark.parametrize("n_fft,hop,win,n_mels,ok", [
    (1024, 256, 1024, 80, True), (1024, 256, 800, 80, True),
    (2048, 512, 2048, 80, True), (1024, 200, 1024, 80, True),
    (1000, 250, 1000, 80, False), (1024, 256, 1024, 128, True),
    (1024, 256, 2048, 80, False), (1024, 4096, 1024, 80, True),
    (256, 1, 256, 40, True), (128, 32, 128, 40, False),
    (4096, 1024, 4096, 80, False), (1024, 0, 1024, 80, False),
    (1024, 256, 1024, 129, False), (1024, 20000, 1024, 80, False)])
def test_kernel_shape_limits(n_fft, hop, win, n_mels, ok):
    assert (kernel_shape_error(n_fft, hop, win, n_mels) is None) == ok


@pytest.mark.parametrize("args", [(22050, 1024, 80, 0.0, None), (16000, 512, 40, 0.0, None),
                                  (22050, 2048, 128, 50.0, 8000.0), (16000, 256, 80, 0.0, None)])
def test_compact_filterbank_rebuilds_dense(args):
    fb = tstft.mel_filterbank(*args)
    bands, weights = compact_filterbank(fb)
    dense = np.zeros_like(fb)
    for m, (first, count, offset) in enumerate(bands):
        dense[m, first:first + count] = weights[offset:offset + count]
    np.testing.assert_array_equal(dense, fb)
    assert weights.dtype == np.float32 and bands.dtype == np.int32
    assert len(weights) < fb.size // 8          # the sparsity the kernel uses


def _tables(n_fft, win_length, n_mels):
    """The wrapper's fp32 tables as numpy: W_M^t, W_N^k, window, bands, weights."""
    c = {k: v.numpy() for k, v in
         _kernel_tables(n_fft, win_length, 22050, n_mels, 0.0, None, "cpu").items()}
    half = n_fft // 2
    tw = c["tables"][:4 * half]
    tw = (tw[0::2] + 1j * tw[1::2]).astype(np.complex64)
    return tw[:half], tw[half:], c["tables"][4 * half:], c["bands"], c["weights"]


def _stockham(z, tw):
    """The kernel's M-point FFT along the last axis: Stockham passes of radix
    8 and a last one of radix 2 or 4, butterfly b reading in[b + r M/R],
    twiddled by W_M^(r k M/(pR)) (k = b mod p), written to out[(b - k) R + k
    + r p]; complex64 throughout."""
    M = z.shape[-1]
    logm = M.bit_length() - 1
    p = 1
    for R in [8] * (logm // 3) + ([1 << logm % 3] if logm % 3 else []):
        b, r = np.arange(M // R), np.arange(R)
        k = b % p
        x = z[..., b[None, :] + r[:, None] * (M // R)] * tw[np.outer(r, k) * (M // (p * R))]
        dft = np.exp(-2j * np.pi * np.outer(r, r) / R).astype(np.complex64)
        out = np.empty_like(z)
        out[..., ((b - k) * R + k)[None, :] + r[:, None] * p] = np.einsum("qr,...rb->...qb",
                                                                           dft, x)
        z, p = out, p * R
    return z


def _kernel_spectrum(frames, tw, tws):
    """Windowed fp32 frames (..., n_fft) -> bins 0 .. n_fft/2 as the kernel
    takes them: packed FFT, then X[k] = E + W_N^k O, X[M] = E[0] - O[0]."""
    z = (frames[..., 0::2] + 1j * frames[..., 1::2]).astype(np.complex64)
    Z = _stockham(z, tw)
    M = Z.shape[-1]
    Zc = np.conj(Z[..., (M - np.arange(M)) % M])
    E, O = 0.5 * (Z + Zc), -0.5j * (Z - Zc)
    WO = tws * O
    return np.concatenate([E + WO, (E[..., :1] - WO[..., :1])], -1)


def _windowed_frames(y, n_fft, hop, window):
    x = np.pad(y, ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft, axis=-1)[:, ::hop]
    return (frames * window).astype(np.float32)


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048])
def test_kernel_fft_decomposition_matches_rfft(n_fft):
    tw, tws, window, _, _ = _tables(n_fft, n_fft, 80)
    y = np.random.RandomState(n_fft).uniform(-0.8, 0.8, (2, 6000)).astype(np.float32)
    frames = _windowed_frames(y, n_fft, n_fft // 4, window)
    got = _kernel_spectrum(frames, tw, tws)
    ref = np.fft.rfft(frames.astype(np.float64), axis=-1)
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _emulate_kernel(y, n_fft=1024, hop=256, win_length=1024, n_mels=80):
    """The kernel's log-mel and energy in numpy fp32, from the wrapper's tables."""
    tw, tws, window, bands, weights = _tables(n_fft, win_length, n_mels)
    X = _kernel_spectrum(_windowed_frames(y, n_fft, hop, window), tw, tws)
    power = (X.real * X.real + X.imag * X.imag).astype(np.float32)
    mag = np.sqrt(power)
    mel = np.stack([mag[..., f:f + n] @ weights[o:o + n] for f, n, o in bands], 1)
    return np.log(np.maximum(mel, np.float32(1e-5))), np.sqrt(power.sum(-1))


@pytest.mark.parametrize("signal", ["noise", "quiet"])
def test_kernel_emulation_matches_plain(signal):
    T = 220500                                   # 10 s at 22.05 kHz
    if signal == "noise":
        y = np.random.RandomState(5).uniform(-0.8, 0.8, (1, T))
    else:                                        # -60 dBFS tone, then silence
        y = np.zeros((1, T))
        y[0, :T // 2] = 1e-3 * np.sin(2 * np.pi * 440.0 * np.arange(T // 2) / 22050.0)
    y = y.astype(np.float32)
    got = _emulate_kernel(y)
    ref = [a.numpy() for a in fused_mel_spectrogram_plain(torch.from_numpy(y))]
    assert got[0].shape == ref[0].shape == (1, 80, T // 256 + 1)
    _close(got, ref)


def test_filterbank_and_window_are_the_tpu_packages():
    for args in ((22050, 1024, 80, 0.0, None), (16000, 400, 40, 0.0, None),
                 (22050, 1024, 80, 50.0, 8000.0)):
        np.testing.assert_array_equal(tstft.mel_filterbank(*args),
                                      jstft.mel_filterbank(*args))
    for n in (1024, 800, 400):
        np.testing.assert_array_equal(tstft._hann_window(n), jstft._hann_window(n))


@pytest.fixture(scope="module")
def tone(jax_stft):
    t = np.arange(4096) / 22050.0
    y = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.05 * np.random.RandomState(2).randn(len(t))).astype(np.float32)[None]
    mag, phase = (np.asarray(a) for a in jax_stft.transform(y))
    return y, mag, phase


def test_transform_matches(tone, port_stft):
    y, mag, phase = tone
    got_mag, got_phase = (a.numpy() for a in port_stft.transform(y))
    np.testing.assert_allclose(got_mag, mag, atol=1e-4, rtol=1e-5)
    # phase only where the bin has energy: atan2 of rounding noise is noise
    loud = mag > 1e-2
    d = np.angle(np.exp(1j * (got_phase[loud] - phase[loud])))
    assert np.abs(d).max() < 1e-3


def test_mel_spectrogram_matches(tone, jax_stft, port_stft):
    y = tone[0]
    _close([a.numpy() for a in port_stft.mel_spectrogram(y)],
           [np.asarray(a) for a in jax_stft.mel_spectrogram(y)])


def test_inverse_matches(tone, jax_stft, port_stft):
    _, mag, phase = tone
    ref = np.asarray(jax.jit(jax_stft.inverse)(mag, phase))
    got = port_stft.inverse(mag, phase).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_griffin_lim_from_the_same_phases(tone, jax_stft, port_stft):
    # JAX draws its phases from jax.random; the port's helper takes them
    _, mag, _ = tone
    angles = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), mag.shape,
                                           minval=-np.pi, maxval=np.pi))
    ref = np.asarray(jax_stft.griffin_lim(jnp.asarray(mag), n_iters=2, seed=0))
    got = port_stft._griffin_lim(mag, angles, n_iters=2).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    own = port_stft.griffin_lim(mag, n_iters=2, seed=0).numpy()
    assert own.shape == ref.shape and np.isfinite(own).all()


def test_stft_refuses_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the STFT would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstft.TacotronSTFT()
