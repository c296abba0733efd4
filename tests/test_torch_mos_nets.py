"""Port: the MOS networks (``evaluation/mosnet.py``, ``mbnet.py``,
``wav2vec2.py``) and the scorer registry (``evaluation/mos.py``) against
the JAX package, on weights written from a seed in the converters' npz
layouts (``tools/convert_torch_weights.py`` ``convert_mosnet_h5``,
``convert_mbnet_pt``, ``convert_wav2vec2_pt``).

MOSNet and MBNet run at their only width (CNN 16-128 channels on 257
bins, BLSTM 128), on 0.5 s of audio; wav2vec2 at a tiny config (2 convs,
hidden 32, 2 heads, 2 layers, a positional kernel of 8, even, so the trim
runs), with and without a regression head, bucketed and not.  Each JAX
reference is compiled once: each scorer's jitted forward at the test
wav's length (reused by its ``score``), and wav2vec2's ``encode``.

Tolerances (fp32; only the order of summation differs): MOSNet and MBNet
frame and utterance scores rel 1e-5 of the largest; wav2vec2 hidden
states and scores rel 1e-4; the magnitude features, ``n_conv_frames`` and
the spectral proxy exactly; ``mos_rows``' means and half-widths within
1e-5 of the mean (wav2vec2's 1e-4), its labels equal.
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from metatts_tpu.evaluation import mbnet as jmb
from metatts_tpu.evaluation import mos as jmos
from metatts_tpu.evaluation import mosnet as jmn
from metatts_tpu.evaluation import wav2vec2 as jw2
from metatts_torch.evaluation import mbnet as tmb
from metatts_torch.evaluation import mos as tmos
from metatts_torch.evaluation import mosnet as tmn
from metatts_torch.evaluation import wav2vec2 as tw2

from torch_port_helpers import one_torch_thread  # noqa: F401

SR = 22050
W2V2 = dict(conv_stride=[5, 2], num_conv_pos_embeddings=8,
            num_conv_pos_embedding_groups=4, num_attention_heads=2,
            num_hidden_layers=2)
W2V2_WIDTHS = dict(kernels=(10, 3), conv=16, hidden=32, ffn=64)


def _u(rng, shape, fan):
    return rng.uniform(-1, 1, shape).astype(np.float32) / np.sqrt(fan)


def write_cnn_blstm(path, seed):
    """MOSNet / MBNet mean-net arrays (HWIO convs, Keras-layout BLSTM)."""
    rng = np.random.RandomState(seed)
    z, c_in = {}, 1
    for i in range(12):
        c_out = (16, 32, 64, 128)[i // 3]
        z[f"conv{i}.kernel"] = _u(rng, (3, 3, c_in, c_out), 9 * c_in)
        z[f"conv{i}.bias"] = _u(rng, (c_out,), 9 * c_in)
        c_in = c_out
    for d in ("fwd", "bwd"):
        z[f"blstm.{d}.kernel"] = _u(rng, (512, 512), 512)
        z[f"blstm.{d}.recurrent"] = _u(rng, (128, 512), 128)
        z[f"blstm.{d}.bias"] = _u(rng, (512,), 128)
    z["dense1.kernel"], z["dense1.bias"] = _u(rng, (256, 128), 256), _u(rng, (128,), 256)
    z["frame.kernel"], z["frame.bias"] = _u(rng, (128, 1), 128), _u(rng, (1,), 128)
    np.savez(path, **z)
    return path


def write_wav2vec2(path, seed, head):
    """Tiny wav2vec2 arrays (WIO convs, (in, out) linears, the config as a
    JSON entry), with or without a (hidden, 1) regression head."""
    rng = np.random.RandomState(seed)
    w = W2V2_WIDTHS
    C, H, Fd, K = w["conv"], w["hidden"], w["ffn"], W2V2["num_conv_pos_embeddings"]
    z = {"config": np.asarray(json.dumps(W2V2))}
    c_in = 1
    for i, k in enumerate(w["kernels"]):
        z[f"conv{i}.kernel"] = _u(rng, (k, c_in, C), k * c_in)
        c_in = C
    z["conv0.gn.scale"] = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    z["conv0.gn.bias"] = (0.1 * rng.randn(C)).astype(np.float32)
    for ln, d in (("fp_ln", C), ("enc_ln", H)):
        z[f"{ln}.scale"] = (1 + 0.1 * rng.randn(d)).astype(np.float32)
        z[f"{ln}.bias"] = (0.1 * rng.randn(d)).astype(np.float32)
    z["proj.kernel"], z["proj.bias"] = _u(rng, (C, H), C), _u(rng, (H,), C)
    g = W2V2["num_conv_pos_embedding_groups"]
    z["pos_conv.kernel"] = _u(rng, (K, H // g, H), K * H // g)
    z["pos_conv.bias"] = _u(rng, (H,), K * H // g)
    for i in range(W2V2["num_hidden_layers"]):
        for nm in ("q", "k", "v", "out"):
            z[f"layer{i}.attn.{nm}.kernel"] = _u(rng, (H, H), H)
            z[f"layer{i}.attn.{nm}.bias"] = _u(rng, (H,), H)
        for nm in ("ln", "final_ln"):
            z[f"layer{i}.{nm}.scale"] = (1 + 0.1 * rng.randn(H)).astype(np.float32)
            z[f"layer{i}.{nm}.bias"] = (0.1 * rng.randn(H)).astype(np.float32)
        z[f"layer{i}.ff_in.kernel"], z[f"layer{i}.ff_in.bias"] = _u(rng, (H, Fd), H), _u(rng, (Fd,), H)
        z[f"layer{i}.ff_out.kernel"], z[f"layer{i}.ff_out.bias"] = _u(rng, (Fd, H), Fd), _u(rng, (H,), Fd)
    if head:
        z["head.kernel"], z["head.bias"] = _u(rng, (H, 1), H), _u(rng, (1,), H)
    np.savez(path, **z)
    return path


def _wav(seed, seconds=0.5):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * (120 + 40 * seed) * t)
            + 0.02 * rng.randn(t.size)).astype(np.float32)


def _rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("mos")
    return {"mosnet": write_cnn_blstm(str(d / "mosnet.npz"), 1),
            "mbnet": write_cnn_blstm(str(d / "mbnet.npz"), 2),
            "w2v2_head": write_wav2vec2(str(d / "w2v2_head.npz"), 3, head=True),
            "w2v2": write_wav2vec2(str(d / "w2v2.npz"), 3, head=False)}


@pytest.mark.parametrize("net", ["mosnet", "mbnet"])
def test_cnn_blstm_matches_jax(weights, net):
    """Features, frame and utterance scores, and ``score``: MOSNet's Keras
    'same' padding ((0, 1) on the 257-bin axis at stride 3 until 10 -> 4),
    MBNet's symmetric padding, both flattening a frame (freq, channel)."""
    jm, tm = (jmn, tmn) if net == "mosnet" else (jmb, tmb)
    j_cls, t_cls = (jmn.MOSNet, tmn.MOSNet) if net == "mosnet" else (jmb.MBNetMean,
                                                                     tmb.MBNetMean)
    j, t = j_cls(weights[net]), t_cls(weights[net], device="cpu")
    wav = _wav(0)
    mag = tm.magnitude_spectrogram(wav, SR)
    np.testing.assert_array_equal(mag, jm.magnitude_spectrogram(wav, SR))
    assert mag.shape == ((32 if net == "mosnet" else 63), 257)
    mags = np.stack([mag, 0.5 * mag[::-1]])
    with torch.no_grad():
        avg, frames = tm.forward(t.params, torch.from_numpy(mags))
    j_avg, j_frames = j._fwd(j.params, jnp.asarray(mags))
    _rel(frames.numpy(), np.asarray(j_frames), 1e-5)
    _rel(avg.numpy(), np.asarray(j_avg), 1e-5)
    _rel(t.score(wav, SR), j.score(wav, SR), 1e-5)


@pytest.mark.parametrize("head", [True, False])
def test_wav2vec2_matches_jax(weights, head):
    """Hidden states, ``n_conv_frames``, and the scorer's default
    (bucketed) and exact scores: the regression head, or the norm proxy."""
    path = weights["w2v2_head" if head else "w2v2"]
    t_b, t_x = (tw2.Wav2Vec2Scorer(path, bucket=b, device="cpu") for b in (True, False))
    j_b, j_x = (jw2.Wav2Vec2Scorer(path, bucket=b) for b in (True, False))
    assert t_b.calibrated == j_b.calibrated == head
    assert t_b.params["config"] == j_b.params["config"]
    wav = _wav(1, 0.4)
    x = np.random.RandomState(2).randn(1, 3000).astype(np.float32)
    for n in (400, 3000, 16000):
        assert tw2.n_conv_frames(t_b.params, n) == jw2.n_conv_frames(j_b.params, n)
    if head:
        with torch.no_grad():
            h = tw2.encode(t_b.params, torch.from_numpy(x))
        cfg = j_b.params["config"]      # static under jit, as the JAX scorer keeps it
        j_h = jax.jit(lambda p, w: jw2.encode(dict(p, config=cfg), w))(j_b._weights,
                                                                       jnp.asarray(x))
        _rel(h.numpy(), np.asarray(j_h), 1e-4)
    for t, j in ((t_b, j_b), (t_x, j_x)):
        _rel(t.score(wav, SR), j.score(wav, SR), 1e-4)
    assert t_b.score(wav, SR) != t_x.score(wav, SR)


def test_registry_and_mos_rows(weights, tmp_path, monkeypatch):
    """The native scorers registered under the JAX package's names, and
    ``mos_rows`` over real wavs and a result tree against the JAX one with
    the same scorers; the spectral proxy exactly."""
    from metatts_torch.preprocess.audio_io import save_wav
    import evaluate as jev
    import metatts_torch.evaluate as tev
    for seed, n in ((0, 300), (1, 5000), (2, SR)):
        w = _wav(seed, n / SR)
        assert tmos._spectral_proxy(w, SR) == jmos._spectral_proxy(w, SR)
    assert tmos._spectral_proxy(np.full(4096, np.nan), SR) == 1.0
    for spk in ("a", "b"):
        for i in range(2):
            (tmp_path / "real" / spk).mkdir(parents=True, exist_ok=True)
            save_wav(str(tmp_path / "real" / spk / f"u{i}.wav"), _wav(i + 3 * (spk == "b")), SR)
    task = tmp_path / "res" / "audio" / "Testing" / "step_last" / "test_000"
    task.mkdir(parents=True)
    for name in ("q.recon", "q-FTstep_0.synth", "q-FTstep_5.synth"):
        save_wav(str(task / f"{name}.wav"), _wav(len(name)), SR)
    monkeypatch.setattr(jmos, "_SCORERS", {"spectral_proxy": jmos._spectral_proxy})
    monkeypatch.setattr(tmos, "_SCORERS", {"spectral_proxy": tmos._spectral_proxy})
    monkeypatch.setattr(jmos, "try_register_wav2vec2", lambda: False)
    args = (str(tmp_path / "real"), str(tmp_path / "res"), "step_last", 16)
    assert tev.mos_rows(*args, device="cpu") == jev.mos_rows(*args)
    kw = dict(mosnet_weights=weights["mosnet"], mbnet_weights=weights["mbnet"],
              wav2vec2_weights=weights["w2v2_head"])
    t_sum, j_sum = {}, {}
    got = tev.mos_rows(*args, device="cpu", summary=t_sum, **kw)
    want = jev.mos_rows(*args, summary=j_sum, **kw)
    assert tmos.available_scorers() == jmos.available_scorers() == [
        "mbnet", "mosnet", "spectral_proxy", "wav2vec2"]
    assert [r[0] for r in got] == [r[0] for r in want] and len(got) == 4 * 4
    assert list(t_sum) == list(j_sum) == ["real", "recon", "synth_step0", "synth_step5"]
    for tag in j_sum:
        assert list(t_sum[tag]) == list(j_sum[tag])
        for name, (m, ci) in j_sum[tag].items():
            rel = 1e-4 if name == "wav2vec2" else 1e-5
            assert abs(t_sum[tag][name][0] - m) <= rel * abs(m), (tag, name)
            assert abs(t_sum[tag][name][1] - ci) <= rel * abs(m), (tag, name)
    assert not tmos.try_register_mosnet_native(str(tmp_path / "none.npz"), device="cpu")
    with pytest.raises(KeyError, match="unavailable"):
        tmos.score("nope", _wav(0), SR)
