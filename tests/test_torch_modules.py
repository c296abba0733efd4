"""Port: each module of the serving slice against its JAX function, at the
tiny config of tests/helpers.py, fp32, eval mode.  Inputs come from numpy
with a fixed seed; parameters cross over through metatts_torch.convert.

Tolerances: atol 1e-5 for layers and blocks (fp32, only the order of
summation differs), 1e-4 for the vocoders (deep conv stacks); integer
outputs (durations, lengths, gathers, collate, text) are exact.
"""

import copy
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from metatts_tpu.models import nn as jnn
from metatts_tpu.models import transformer as jtr
from metatts_tpu.models import vocoder as jvoc
from metatts_tpu.models.variance_adaptor import variance_adaptor_apply
from metatts_tpu.ops.length_regulator import length_regulate as jlr
from metatts_tpu.data.collate import collate_batch as jcollate
from metatts_tpu.text import text_to_sequence as jtext
from metatts_torch import config as TC
from metatts_torch.convert import (fs2_state_dict_from_jax, tree_state_dict,
                                   fft_block_state_dict_from_jax)
from metatts_torch.data.collate import collate_batch as tcollate
from metatts_torch.models import nn as tnn
from metatts_torch.models import vocoder as tvoc
from metatts_torch.models.fastspeech2 import FastSpeech2
from metatts_torch.models.transformer import FFTBlock, _Precision, sinusoid_table
from metatts_torch.ops.length_regulator import length_regulate as tlr
from metatts_torch.text import text_to_sequence as ttext

from helpers import tiny_model_cfg, tiny_preprocess_cfg, algorithm_cfg, STATS
from torch_port_helpers import fill_tree, fs2_params, one_torch_thread  # noqa: F401

ATOL = 1e-5
f32 = jnp.float32


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def model():
    pcfg, mcfg, acfg = tiny_preprocess_cfg(), tiny_model_cfg(), algorithm_cfg("meta")
    # random BatchNorm running state and LayerNorm affines (fill_tree), so
    # the eval BN and the norms' parameters are exercised
    params, state = fs2_params(pcfg, mcfg, acfg, STATS, 4)
    port = FastSpeech2(pcfg, mcfg, acfg, STATS, 4).eval()
    port.load_state_dict(fs2_state_dict_from_jax(params, state), strict=True)
    return dict(pcfg=pcfg, mcfg=mcfg, acfg=acfg, params=params, state=state,
                port=port)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_linear(cd):
    rng = np.random.RandomState(0)
    w, b = rng.randn(12, 7).astype(np.float32), rng.randn(7).astype(np.float32)
    x = rng.randn(3, 5, 12).astype(np.float32)
    ref = jnn.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                     jnp.dtype(cd))
    m = tnn.Linear(12, 7)
    m.load_state_dict({"weight": torch.from_numpy(w.T.copy()),
                       "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = m(torch.from_numpy(x), tnn.dtype(cd))
    assert got.dtype == torch.float32
    _close(got, ref)


def test_embedding_and_layer_norm():
    rng = np.random.RandomState(1)
    table = rng.randn(10, 6).astype(np.float32)
    ids = rng.randint(0, 10, size=(2, 5)).astype(np.int32)
    e = tnn.Embedding(10, 6)
    e.load_state_dict({"weight": torch.from_numpy(table)})
    _close(e(torch.from_numpy(ids)),
           jnn.embedding({"table": jnp.asarray(table)}, jnp.asarray(ids)))
    x = rng.randn(2, 5, 6).astype(np.float32) * 3 + 1
    s, b = rng.randn(6).astype(np.float32), rng.randn(6).astype(np.float32)
    ln = tnn.LayerNorm(6)
    ln.load_state_dict({"weight": torch.from_numpy(s), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        _close(ln(torch.from_numpy(x)),
               jnn.layer_norm({"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
                              jnp.asarray(x)))


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm(train):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 7, 5).astype(np.float32) * 2 + 0.5
    p = {"scale": rng.randn(5).astype(np.float32), "bias": rng.randn(5).astype(np.float32)}
    s = {"mean": rng.randn(5).astype(np.float32),
         "var": rng.uniform(0.5, 2, 5).astype(np.float32)}
    ref, ref_state = jnn.batch_norm(jax.tree.map(jnp.asarray, p),
                                    jax.tree.map(jnp.asarray, s),
                                    jnp.asarray(x), train)
    bn = tnn.BatchNorm(5)
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"])})
    bn.train(train)
    with torch.no_grad():
        got = bn(torch.from_numpy(x))
    _close(got, ref)
    _close(bn.running_mean, ref_state["mean"])
    _close(bn.running_var, ref_state["var"])


@pytest.mark.parametrize("k,dil", [(1, 1), (3, 1), (9, 1), (5, 2)])
def test_conv1d(k, dil):
    rng = np.random.RandomState(3)
    w = rng.randn(7, 5, k).astype(np.float32) * 0.3
    b = rng.randn(7).astype(np.float32)
    x = rng.randn(2, 16, 5).astype(np.float32)
    ref = jnn.conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                     dilation=dil)
    m = tnn.Conv1d(5, 7, k)
    m.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        _close(m(torch.from_numpy(x), dilation=dil), ref)


@pytest.mark.parametrize("stride,k,pad", [(8, 16, 4), (2, 4, 1), (8, 16, 0)])
def test_conv_transpose1d(stride, k, pad):
    rng = np.random.RandomState(4)
    w = rng.randn(6, 4, k).astype(np.float32) * 0.3
    b = rng.randn(4).astype(np.float32)
    x = rng.randn(2, 9, 6).astype(np.float32)
    ref = jnn.conv_transpose1d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               jnp.asarray(x), stride, padding=pad)
    m = tnn.ConvTranspose1d(6, 4, k)
    m.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = m(torch.from_numpy(x).transpose(1, 2), stride, padding=pad)
    _close(got.transpose(1, 2), ref)


# ----------------------------------------------------------- transformer

def test_sinusoid_table():
    assert np.array_equal(sinusoid_table(37, 32), jtr.sinusoid_table(37, 32))


def test_fft_block_eval():
    D, H, F = 32, 2, 48
    p = fill_tree(jax.eval_shape(lambda k: jtr.fft_block_init(
        k, D, H, D // H, D // H, F, [9, 1]), jax.random.PRNGKey(0)), 3)
    x = np.random.RandomState(5).randn(3, 20, D).astype(np.float32)
    valid = np.arange(20)[None, :] < np.array([20, 13, 0])[:, None]
    ref = jax.jit(lambda p_, x_, v_: jtr.fft_block(
        p_, x_, v_, H, cdtype=f32, drop_rate=0.0, train=False, rng=None))(
            p, jnp.asarray(x), jnp.asarray(valid))
    blk = FFTBlock(D, H, F, [9, 1]).eval()
    blk.load_state_dict(fft_block_state_dict_from_jax(p))
    prec = _Precision({})                  # fp32 compute, scores, activations
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(valid), H, prec)
    _close(got, ref)
    assert np.abs(_np(got)[~valid]).max() == 0.0


def test_encoder(model):
    rng = np.random.RandomState(6)
    texts = rng.randint(1, 360, size=(2, 16)).astype(np.int32)
    valid = np.arange(16)[None, :] < np.array([16, 9])[:, None]
    table = sinusoid_table(65, 32)
    ref = jax.jit(lambda p_, t_, v_, pt: jtr.encoder_apply(
        p_, t_, v_, model["mcfg"], train=False, rng=None, pos_table=pt))(
            model["params"]["encoder"], jnp.asarray(texts), jnp.asarray(valid),
            jnp.asarray(table))
    with torch.no_grad():
        got = model["port"].encoder(torch.from_numpy(texts),
                                    torch.from_numpy(valid),
                                    torch.from_numpy(table))
    _close(got, ref)


def test_decoder(model):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 24, 32).astype(np.float32)
    valid = np.arange(24)[None, :] < np.array([24, 5])[:, None]
    table = sinusoid_table(65, 32)
    ref = jax.jit(lambda p_, x_, v_, pt: jtr.decoder_apply(
        p_, x_, v_, model["mcfg"], train=False, rng=None, pos_table=pt))(
            model["params"]["decoder"], jnp.asarray(x), jnp.asarray(valid),
            jnp.asarray(table))
    with torch.no_grad():
        got = model["port"].decoder(torch.from_numpy(x), torch.from_numpy(valid),
                                    torch.from_numpy(table))
    _close(got, ref)


def test_postnet_eval(model):
    mel = np.random.RandomState(8).randn(2, 30, 8).astype(np.float32)
    ref, _ = jax.jit(lambda p_, s_, m_: jtr.postnet_apply(
        p_, s_, m_, cdtype=f32, train=False, rng=None))(
            model["params"]["postnet"], model["state"]["postnet"], jnp.asarray(mel))
    with torch.no_grad():
        got = model["port"].postnet(torch.from_numpy(mel))
    _close(got, ref)


# ------------------------------------------------------ variance adaptor

def test_length_regulator_exact():
    rng = np.random.RandomState(9)
    x = rng.randn(3, 7, 4).astype(np.float32)
    d = rng.randint(0, 5, size=(3, 7)).astype(np.int32)
    d[2] = 0
    for T in (10, 40):
        ref, ref_len = jlr(jnp.asarray(x), jnp.asarray(d), T)
        got, got_len = tlr(torch.from_numpy(x), torch.from_numpy(d), T)
        assert np.array_equal(_np(got), np.asarray(ref))
        assert np.array_equal(_np(got_len), np.asarray(ref_len))


@pytest.mark.parametrize("forced", [False, True])
def test_variance_adaptor(model, forced):
    rng = np.random.RandomState(10)
    B, L, T = 3, 12, 64
    x = rng.randn(B, L, 32).astype(np.float32)
    src_valid = np.arange(L)[None, :] < np.array([12, 7, 3])[:, None]
    params = copy.deepcopy(model["params"]["variance_adaptor"])
    # bias the duration predictor so predicted durations are not all 0
    params["duration_predictor"]["linear"]["b"] = np.full((1,), 1.2, np.float32)
    port = FastSpeech2(model["pcfg"], model["mcfg"], model["acfg"], STATS, 4).eval()
    port.load_state_dict(fs2_state_dict_from_jax(
        dict(model["params"], variance_adaptor=params), model["state"]))
    kw = {}
    if forced:
        kw = dict(p_targets=rng.randn(B, L).astype(np.float32),
                  e_targets=rng.randn(B, L).astype(np.float32),
                  d_targets=rng.randint(0, 5, (B, L)).astype(np.int32))
    mel_valid = np.ones((B, T), bool) if forced else None
    ref = jax.jit(lambda p_, x_, sv, mv, kw_: variance_adaptor_apply(
        p_, x_, sv, model["mcfg"], model["pcfg"], max_mel_len=T, mel_valid=mv,
        p_control=1.1, e_control=0.9, d_control=1.3, **kw_))(
            params, jnp.asarray(x), jnp.asarray(src_valid),
            None if mel_valid is None else jnp.asarray(mel_valid),
            {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = port.variance_adaptor(
            torch.from_numpy(x), torch.from_numpy(src_valid), max_mel_len=T,
            mel_valid=None if mel_valid is None else torch.from_numpy(mel_valid),
            p_control=1.1, e_control=0.9, d_control=1.3,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
    x_r, p_r, e_r, logd_r, d_r, len_r, mv_r = ref
    x_g, p_g, e_g, logd_g, d_g, len_g, mv_g = got
    assert np.array_equal(_np(d_g), np.asarray(d_r))
    assert np.array_equal(_np(len_g), np.asarray(len_r))
    assert np.array_equal(_np(mv_g), np.asarray(mv_r))
    assert np.asarray(len_r).max() > 0
    for a, b in ((x_g, x_r), (p_g, p_r), (e_g, e_r), (logd_g, logd_r)):
        _close(a, b)


# ---------------------------------------------------------- data / text

def test_collate_exact():
    rng = np.random.RandomState(11)
    samples = []
    for i, (n, t) in enumerate(((5, 40), (33, 300), (12, 90))):
        d = rng.randint(1, 20, n).astype(np.int32)
        samples.append({"id": str(i), "speaker": i, "raw_text": "x",
                        "text": rng.randint(1, 360, n).astype(np.int32),
                        "mel": rng.randn(t, 8).astype(np.float32),
                        "pitch": rng.randn(n).astype(np.float32),
                        "energy": rng.randn(n).astype(np.float32),
                        "duration": d})
    for kw in ({}, {"with_mels": False}, {"max_seq_len": 256}):
        ref, _ = jcollate(samples, **kw)
        got, _ = tcollate(samples, **kw)
        for name in ref._fields:
            r, g = getattr(ref, name), getattr(got, name)
            assert (r is None) == (g is None), name
            if r is not None:
                assert np.array_equal(np.asarray(r, np.float32) if name == "mels"
                                      else np.asarray(r), _np(g)), name


@pytest.mark.parametrize("text", [
    "Hello, world!", "Dr. Smith paid $3.50 on the 2nd of May, 1999.",
    "{HH AH0 L OW1} there", "Mixed {sp} silence {spn} and {sil}.",
    "  Many   spaces  ", "Ünïcödé façade — naïve café"])
def test_text_to_sequence_exact(text):
    assert ttext(text, ["english_cleaners"]) == jtext(text, ["english_cleaners"])


def test_base_configs_equal_yaml():
    from metatts_tpu import config as JC
    pcfg, mcfg, acfg = TC.base_configs()
    root = os.path.join(os.path.dirname(__file__), "..", "config")
    assert pcfg == JC.load_preprocess_configs(
        [os.path.join(root, "preprocess", "LibriTTS.yaml")])[0]
    assert mcfg == JC.load_model_config(os.path.join(root, "model", "base.yaml"))
    assert acfg == JC.load_algorithm_config(
        os.path.join(root, "algorithm", "meta_emb_vad.yaml"))
    for a, b in ((TC.MODEL_DEFAULTS, JC.MODEL_DEFAULTS),
                 (TC.PREPROCESS_DEFAULTS, JC.PREPROCESS_DEFAULTS),
                 (TC.ALGORITHM_DEFAULTS, JC.ALGORITHM_DEFAULTS),
                 (TC.TRAIN_DEFAULTS, JC.TRAIN_DEFAULTS)):
        assert a == b


# ---------------------------------------------------------------- vocoders

def _np_tree(net, seed):
    """The JAX package's parameter tree for ``net``'s architecture, filled
    from numpy (JAX's own random init of these trees is slow on the CPU)."""
    rng = np.random.RandomState(seed)
    root = {}
    for name, t in net.state_dict().items():
        *path, leaf = name.split(".")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        scale = 1.0 / np.sqrt(np.prod(t.shape[1:]) if t.dim() > 1 else t.shape[0])
        node[{"weight": "w", "bias": "b"}[leaf]] = (
            rng.uniform(-scale, scale, tuple(t.shape)).astype(np.float32))

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


@pytest.mark.parametrize("kind", ["MelGAN", "HiFi-GAN"])
def test_vocoder(kind):
    mel = np.random.RandomState(12).randn(2, 6, 8).astype(np.float32)
    net = tvoc.MelGAN(n_mels=8) if kind == "MelGAN" else tvoc.HiFiGAN(n_mels=8)
    apply = jvoc.melgan_apply if kind == "MelGAN" else jvoc.hifigan_apply
    p = _np_tree(net, 1)
    ref = jax.jit(apply)(p, jnp.asarray(mel))
    net.load_state_dict(tree_state_dict(p), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(mel))
    assert got.shape == ref.shape == (2, 6 * 256)
    _close(got, ref, atol=1e-4)


def test_melgan_params_from_npz_matches():
    """The official-layout loader maps every tensor where the JAX one does."""
    p = _np_tree(tvoc.MelGAN(n_mels=8), 2)
    w = {"model.1.weight": p["conv_in"]["w"], "model.1.bias": p["conv_in"]["b"]}
    idx = 2
    for up in p["ups"]:
        w[f"model.{idx + 1}.weight"] = up["convt"]["w"]
        w[f"model.{idx + 1}.bias"] = up["convt"]["b"]
        for j, blk in enumerate(up["blocks"]):
            for name, key in (("block.2", "conv_d"), ("block.4", "conv_1"),
                              ("shortcut", "shortcut")):
                w[f"model.{idx + 2 + j}.{name}.weight"] = blk[key]["w"]
                w[f"model.{idx + 2 + j}.{name}.bias"] = blk[key]["b"]
        idx += 5
    w[f"model.{idx + 2}.weight"] = p["conv_out"]["w"]
    w[f"model.{idx + 2}.bias"] = p["conv_out"]["b"]
    jp = jvoc.melgan_params_from_npz(w)
    sd = tvoc.melgan_params_from_npz(w)
    ref = tree_state_dict(jax.tree.map(np.asarray, jp))
    assert sorted(sd) == sorted(ref)
    for k in sd:
        assert np.array_equal(sd[k].numpy(), ref[k].numpy()), k
