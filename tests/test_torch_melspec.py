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
plain version, which is what these tests reach.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from metatts_tpu.ops.pallas.melspec import fused_mel_spectrogram as jax_fused
from metatts_tpu.ops import stft as jstft
from metatts_torch.ops import stft as tstft
from metatts_torch.ops.melspec import (fused_mel_spectrogram,
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
    (2048, 512, 2048, 80, True), (1024, 200, 1024, 80, False),
    (1000, 250, 1000, 80, False), (1024, 256, 1024, 128, False),
    (1024, 256, 2048, 80, False), (1024, 4096, 1024, 80, False)])
def test_kernel_shape_limits(n_fft, hop, win, n_mels, ok):
    assert (kernel_shape_error(n_fft, hop, win, n_mels) is None) == ok


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
