"""Port: the serving slice as a whole against the JAX package.

* the teacher-forced and the synthesis FastSpeech2 forward against
  ``fastspeech2_apply`` (tiny config, fp32): mel and postnet mel atol 1e-4,
  predictions atol 1e-4, durations and lengths exact;
* ``SynthesisEngine.synthesize`` against the JAX engine, at the tiny config
  (unfused blocks on both sides) and at a D=128 config whose blocks take the
  fused path (the Pallas kernel in interpret mode on the JAX side, the
  kernel's plain version on the port's CPU side).
"""

import numpy as np
import pytest
import torch
import jax

import metatts_tpu.ops.pallas.fftblock as FB
from metatts_tpu.models import vocoder as jvoc
from metatts_tpu.models.fastspeech2 import fastspeech2_apply
from metatts_tpu.serve import SynthesisEngine as JaxEngine
from metatts_torch.data.collate import Batch as TBatch
from metatts_torch.models import transformer
from metatts_torch.models.fastspeech2 import FastSpeech2
from metatts_torch.ops.fftblock import fused_fft_block
from metatts_torch.serve import SynthesisEngine

from helpers import (tiny_model_cfg, tiny_preprocess_cfg, algorithm_cfg,
                     synth_batch, STATS)
from torch_port_helpers import fill_tree, fs2_params, one_torch_thread  # noqa: F401

TEXTS = ["hello world", "{HH AH0 L OW1} there, general kenobi", "a b"]
SPEAKERS = [0, 3, 1]
ATOL = 1e-4


def _init(mcfg, seed=0, dur_bias=1.6):
    pcfg, acfg = tiny_preprocess_cfg(), algorithm_cfg("meta")
    params, state = fs2_params(pcfg, mcfg, acfg, STATS, 4, seed)
    # random weights predict ~0 frames; a bias on the log-duration gives a few
    params["variance_adaptor"]["duration_predictor"]["linear"]["b"] = \
        np.full((1,), dur_bias, np.float32)
    return pcfg, acfg, params, state


def _port_batch(b):
    return TBatch(*(None if v is None else torch.from_numpy(np.asarray(v))
                    for v in b))


@pytest.fixture(scope="module")
def tiny():
    mcfg = tiny_model_cfg()
    pcfg, acfg, params, state = _init(mcfg)
    port = FastSpeech2(pcfg, mcfg, acfg, STATS, 4).eval()
    from metatts_torch.convert import load_fs2_from_jax
    load_fs2_from_jax(port, params, state)
    return mcfg, pcfg, acfg, params, state, port


@pytest.mark.parametrize("teacher_forced", [True, False])
def test_forward_matches_fastspeech2_apply(tiny, teacher_forced):
    mcfg, pcfg, acfg, params, state, port = tiny
    batch = synth_batch(np.random.RandomState(3), B=3, L=12, T=48, n_mels=8)
    kw = dict(teacher_forced=teacher_forced, p_control=1.2, e_control=0.8,
              d_control=1.1)
    if not teacher_forced:
        kw["max_mel_len"] = 64
    ref, _ = jax.jit(lambda p, s, b: fastspeech2_apply(
        p, s, b, mcfg, pcfg, acfg, train=False, **kw))(params, state, batch)
    with torch.no_grad():
        got = port(_port_batch(batch), **kw)
    assert np.array_equal(got.d_rounded.numpy(), np.asarray(ref.d_rounded))
    assert np.array_equal(got.mel_lens.numpy(), np.asarray(ref.mel_lens))
    assert np.array_equal(got.mel_valid.numpy(), np.asarray(ref.mel_valid))
    assert np.array_equal(got.src_valid.numpy(), np.asarray(ref.src_valid))
    assert np.asarray(ref.mel_lens).min() > 0
    for name in ("mel", "postnet_mel", "p_pred", "e_pred", "log_d_pred"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=ATOL, err_msg=name)


def test_forward_average_spk_emb(tiny):
    mcfg, pcfg, acfg, params, state, port = tiny
    # the batch of test_forward_matches_fastspeech2_apply: JAX reuses the
    # operations it compiled for those shapes
    batch = synth_batch(np.random.RandomState(3), B=3, L=12, T=48, n_mels=8)
    ref, _ = jax.jit(lambda p, s, b: fastspeech2_apply(
        p, s, b, mcfg, pcfg, acfg, train=False, average_spk_emb=True))(
            params, state, batch)
    with torch.no_grad():
        got = port(_port_batch(batch), average_spk_emb=True)
    np.testing.assert_allclose(got.postnet_mel.numpy(),
                               np.asarray(ref.postnet_mel), rtol=0, atol=ATOL)


def test_forward_refuses_training_mode(tiny, monkeypatch):
    """The fused block is an eval kernel: a training forward asked for it
    runs the unfused training blocks instead."""
    *_, port = tiny
    calls = []
    monkeypatch.setattr(transformer, "fused_fft_block",
                        lambda *a, **k: calls.append(1) or fused_fft_block(*a, **k))
    batch = _port_batch(synth_batch(np.random.RandomState(0), B=1))
    port.train()
    try:
        with torch.no_grad():
            got = port(batch, fused_infer=True, update_bn_state=False)
            ref = port(batch, fused_infer=False, update_bn_state=False)
    finally:
        port.eval()
    assert calls == []
    assert torch.equal(got.postnet_mel, ref.postnet_mel)


def _engines(mcfg, monkeypatch, seed=0):
    pcfg, acfg, params, state = _init(mcfg, seed)
    init = jvoc.melgan_init
    monkeypatch.setattr(jvoc, "melgan_init", lambda rng, n_mels: fill_tree(
        jax.eval_shape(lambda k: init(k, n_mels=n_mels), rng), seed + 10))
    jeng = JaxEngine(params, state, pcfg, mcfg, acfg)
    voc = jax.tree.map(np.asarray, jeng.vocoder.params)
    teng = SynthesisEngine.from_jax_params(params, state, pcfg, mcfg, acfg,
                                           STATS, 4, vocoder_params=voc,
                                           device="cpu")
    return jeng, teng


def _compare(ref, got, mel_atol, wav_atol):
    assert len(ref) == len(got)
    for (rw, rm), (gw, gm) in zip(ref, got):
        assert gw.dtype == np.int16
        assert gm.shape == rm.shape and rm.shape[0] > 0
        assert len(gw) == len(rw) == gm.shape[0] * 256
        np.testing.assert_allclose(gm, rm, rtol=0, atol=mel_atol)
        assert np.abs(gw.astype(np.int32) - rw.astype(np.int32)).max() <= wav_atol


def test_synthesize_matches_jax_engine_tiny(monkeypatch):
    # fp32 throughout: mels to 1e-4; int16 wavs to a few counts (1e-4 of
    # float amplitude is 3.3 counts before truncation)
    jeng, teng = _engines(tiny_model_cfg(), monkeypatch)
    kw = dict(speakers=SPEAKERS, mel_cap=64, d_control=1.2)
    _compare(jeng.synthesize(TEXTS, **kw), teng.synthesize(TEXTS, **kw),
             mel_atol=ATOL, wav_atol=4)


def test_synthesize_matches_jax_engine_fused(monkeypatch):
    """D=128: every block takes the fused path on both sides."""
    calls = {"jax": 0, "port": 0}

    def interpret(*a, **k):
        calls["jax"] += 1
        return orig(*a, interpret=True, **k)

    def port_spy(*a, **k):
        calls["port"] += 1
        return fused_fft_block(*a, **k)

    orig = FB.fused_fft_block
    monkeypatch.setattr(FB, "fused_fft_block", interpret)
    monkeypatch.setattr(transformer, "fused_fft_block", port_spy)
    mcfg = tiny_model_cfg()
    mcfg["transformer"].update(encoder_hidden=128, decoder_hidden=128,
                               conv_filter_size=256)
    mcfg["_fused_interpret"] = True
    jeng, teng = _engines(mcfg, monkeypatch, seed=1)
    # both sides round to bf16 at the same places inside the blocks; fp32
    # summation order differs, so a few values land one bf16 step apart
    # (observed max |dmel| 7e-4 on |mel| ~1.6): mels to 3e-3, wavs to 100
    # counts (3e-3 of full scale)
    kw = dict(speakers=SPEAKERS, mel_cap=64)
    before = fused_fft_block.launches
    ref = jeng.synthesize(TEXTS, **kw)
    got = teng.synthesize(TEXTS, **kw)
    assert calls["jax"] == calls["port"] == 2     # 1 encoder + 1 decoder block
    assert fused_fft_block.launches == before     # CPU: plain version, no kernel
    _compare(ref, got, mel_atol=3e-3, wav_atol=100)
