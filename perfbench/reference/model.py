"""The plain reference: FastSpeech2, its loss and the MelGAN generator as
functions of a name -> tensor dict, in float32 with TF32 off, written from
the published description (FastSpeech2, ming024's implementation that
Meta-TTS builds on; MelGAN, descriptinc/melgan-neurips).  It imports
nothing of the program.

Departures from the published description, each as the system under test
has it (the JAX package and its port):

* the mel L1 terms of the loss sum over the mel bins and divide by the
  valid frames, where ming024's ``masked_select`` + mean divides by the
  valid elements (frames x bins): 80x the published mel terms;
* dropout masks derive from one seed a forward, by a splitmix64 tree
  (``fold_in``), each mask drawn by ``torch.rand`` from a generator on the
  device seeded with its own seed, so the reference replays the masks of
  a training step from the step's seed;
* a lookup of a pitch or energy bin is a left-sided search of the edges.

``Precision`` rounds the inputs of every product to fewer mantissa bits
(the exponent keeps fp32's range): 23 is float32 itself, 10 TF32, 7
bfloat16, 3 fp8 (e4m3).  Products accumulate in float32.
"""

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

_M64 = (1 << 64) - 1
LEAKY = 0.2
MELGAN_RATIOS = (8, 8, 2, 2)
MELGAN_DILATIONS = (1, 3, 9)


def fold_in(seed, i):
    """splitmix64 of ``seed`` and ``i`` -> a 63-bit seed."""
    z = (seed * 0x9E3779B97F4A7C15 + i + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def split(seed, n):
    return [None if seed is None else fold_in(seed, i) for i in range(n)]


def round_mantissa(x, bits):
    """``x`` (float32) rounded to ``bits`` mantissa bits, half to even; its
    derivative is taken as 1, so that gradients flow through it."""
    if bits >= 23:
        return x
    shift = 23 - bits
    xd = x.detach()
    xi = xd.contiguous().view(torch.int32)
    lsb = (xi >> shift) & 1
    xi = (xi + ((1 << (shift - 1)) - 1) + lsb) & ~((1 << shift) - 1)
    return x + (xi.view(torch.float32) - xd)


class Precision:
    """Mantissa bits of the acoustic model's and the vocoder's product
    inputs."""

    def __init__(self, acoustic=23, vocoder=23):
        self.acoustic, self.vocoder = acoustic, vocoder

    def a(self, x):
        return round_mantissa(x, self.acoustic)

    def v(self, x):
        return round_mantissa(x, self.vocoder)


FP32 = Precision()
BITS = {"bfloat16": 7, "fp8": 3}


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ layers

def linear(x, P, name, q):
    return q(x) @ q(P[name + ".weight"]).T + P[name + ".bias"]


def conv(x, P, name, q, dilation=1):
    """SAME conv over (B, T, C); kernel (out, in, k)."""
    w = P[name + ".weight"]
    y = F.conv1d(q(x.transpose(1, 2)), q(w), None, dilation=dilation,
                 padding=dilation * (w.shape[-1] - 1) // 2)
    return (y + P[name + ".bias"][:, None]).transpose(1, 2)


def layer_norm(x, P, name):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], 1e-5)


def dropout(x, rate, seed, train):
    if not train or seed is None or rate == 0.0:
        return x
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


def sinusoid_table(n, d):
    pos = np.arange(n)[:, None]
    dim = np.arange(d)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d)
    table = np.zeros((n, d), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def lengths_mask(lens, n):
    return torch.arange(n, device=lens.device)[None, :] < lens[:, None]


# ---------------------------------------------------------------- FastSpeech2

def fft_block(x, valid, P, name, heads, q, rate, seed, train):
    """Post-LN self-attention and a conv FFN, zeroed at padded rows."""
    B, T, D = x.shape
    r1, r2 = split(seed, 2)
    a = name + ".slf_attn"
    dk = D // heads
    qh = linear(x, P, a + ".w_qs", q).view(B, T, heads, dk) / math.sqrt(dk)
    kh = linear(x, P, a + ".w_ks", q).view(B, T, heads, dk)
    vh = linear(x, P, a + ".w_vs", q).view(B, T, heads, dk)
    s = torch.einsum("bqhd,bkhd->bhqk", q(qh), q(kh))
    s = torch.where(valid[:, None, None, :], s, torch.full((), -1e9, device=x.device))
    o = torch.einsum("bhqk,bkhd->bqhd", q(torch.softmax(s, -1)), q(vh)).reshape(B, T, D)
    o = dropout(linear(o, P, a + ".fc", q), rate, r1, train)
    keep = valid[..., None]
    x = torch.where(keep, layer_norm(o + x, P, a + ".layer_norm"), 0.0)
    f = name + ".pos_ffn"
    h = torch.relu(conv(x, P, f + ".w_1", q))
    h = dropout(conv(h, P, f + ".w_2", q), rate, r2, train)
    return torch.where(keep, layer_norm(h + x, P, f + ".layer_norm"), 0.0)


def stack(x, valid, P, name, cfg, q, seed, train):
    t = cfg["transformer"]
    kind = "encoder" if name == "encoder" else "decoder"
    for i in range(t[kind + "_layer"]):
        x = fft_block(x, valid, P, f"{name}.layer_stack.{i}", t[kind + "_head"], q,
                      t[kind + "_dropout"], None if seed is None else fold_in(seed, i), train)
    return x


def variance_predictor(x, valid, P, name, q, rate, seed, train):
    r1, r2 = split(seed, 2)
    c = name + ".conv_layer"
    h = torch.relu(conv(x, P, c + ".conv1d_1.conv", q))
    h = dropout(layer_norm(h, P, c + ".layer_norm_1"), rate, r1, train)
    h = torch.relu(conv(h, P, c + ".conv1d_2.conv", q))
    h = dropout(layer_norm(h, P, c + ".layer_norm_2"), rate, r2, train)
    out = linear(h, P, name + ".linear_layer", q)[..., 0]
    return torch.where(valid, out, 0.0)


def bins(lo, hi, n):
    return torch.from_numpy(np.linspace(lo, hi, n - 1).astype(np.float32))


def regulate(x, durations, n_frames):
    """Frame t of utterance b takes phoneme l where cum[l] - d[l] <= t <
    cum[l]; frames past sum(d) are 0."""
    cum = torch.cumsum(durations, -1)
    t = torch.arange(n_frames, device=x.device)
    idx = torch.searchsorted(cum, t.expand(x.shape[0], -1).contiguous(), right=True)
    inside = idx < durations.shape[1]
    g = torch.gather(x, 1, idx.clamp(max=durations.shape[1] - 1)[..., None].expand(-1, -1, x.shape[-1]))
    return torch.where(inside[..., None], g, 0.0), cum[:, -1].clamp(max=n_frames)


class Out(NamedTuple):
    mel: torch.Tensor
    postnet_mel: torch.Tensor
    p_pred: torch.Tensor
    e_pred: torch.Tensor
    log_d_pred: torch.Tensor
    src_valid: torch.Tensor
    mel_valid: torch.Tensor
    mel_lens: torch.Tensor


def postnet(mel, P, q, seed, train):
    """Five convs (k 5) with BatchNorm (batch statistics over every frame
    in training, the running statistics otherwise), tanh but the last,
    dropout 0.5."""
    x = mel
    for i in range(5):
        name = f"postnet.convolutions.{i}"
        x = conv(x, P, name + ".0.conv", q)
        if train:
            x = (x - x.mean((0, 1))) * torch.rsqrt(x.var((0, 1), unbiased=False) + 1e-5)
        else:
            # the running statistics of a model that has not trained: 0, 1
            x = x / math.sqrt(1.0 + 1e-5)
        x = x * P[name + ".1.weight"] + P[name + ".1.bias"]
        if i < 4:
            x = torch.tanh(x)
        x = dropout(x, 0.5, None if seed is None else fold_in(seed, i), train)
    return x


def fastspeech2(P, cfg, stats, batch, *, q=FP32.a, train, seed=None, durations=None,
                p_bins_from=None, e_bins_from=None, n_frames=None):
    """The forward.  ``batch``: dict of texts (B, L), src_lens, speakers and,
    teacher-forced, d_targets / p_targets / e_targets.  Without targets the
    forward follows the given ``durations`` and looks up the bins of
    ``p_bins_from`` / ``e_bins_from`` (the values a served forward
    predicted), as a reference that follows a served model's decisions."""
    t = cfg["model"]["transformer"]
    dev = batch["texts"].device
    L = batch["texts"].shape[1]
    teacher = "d_targets" in batch
    T = n_frames or (batch["mels"].shape[1] if teacher else cfg["model"]["max_seq_len"])
    src_valid = lengths_mask(batch["src_lens"], L)
    pos = torch.from_numpy(sinusoid_table(max(cfg["model"]["max_seq_len"], T) + 1,
                                          t["encoder_hidden"])).to(dev)
    r_enc, r_va, r_dec, r_post = split(seed, 4)
    x = P["encoder.src_word_emb.weight"][batch["texts"].long()] + pos[None, :L]
    x = stack(x, src_valid, P, "encoder", cfg["model"], q, r_enc, train)
    s_emb = P["speaker_emb.model.weight"][batch["speakers"].long()]
    x = x + s_emb[:, None]
    rate = cfg["model"]["variance_predictor"]["dropout"]
    seeds = split(r_va, 4)
    va = "variance_adaptor."
    log_d = variance_predictor(x, src_valid, P, va + "duration_predictor", q, rate, seeds[0], train)
    n_bins = cfg["model"]["variance_embedding"]["n_bins"]
    preds = []
    for kind, s, given in (("pitch", seeds[1], p_bins_from), ("energy", seeds[2], e_bins_from)):
        pred = variance_predictor(x, src_valid, P, va + kind + "_predictor", q, rate, s, train)
        value = batch[kind[0] + "_targets"] if teacher else given
        edges = bins(stats[kind][0], stats[kind][1], n_bins).to(dev)
        idx = torch.bucketize(value.contiguous(), edges, right=False)
        x = x + P[va + kind + "_embedding.weight"][idx]
        preds.append(pred)
    d = batch["d_targets"] if teacher else durations
    x, mel_lens = regulate(x, d.long(), T)
    mel_valid = lengths_mask(mel_lens, T)
    x = x + s_emb[:, None] + pos[None, :T]
    x = stack(x, mel_valid, P, "decoder", cfg["model"], q, r_dec, train)
    mel = linear(x, P, "mel_linear", q)
    post = mel + postnet(mel, P, q, r_post, train)
    return Out(mel, post, preds[0], preds[1], log_d, src_valid, mel_valid, mel_lens)


def loss(out, batch):
    """(total, mel, postnet_mel, pitch, energy, duration), masked means."""
    def mean(err, m):
        m = m.float()
        return (err * m).sum() / m.sum().clamp_min(1.0)
    tgt = batch["mels"][:, :out.mel.shape[1]]
    fm = out.mel_valid[..., None]
    mel = mean((out.mel - tgt).abs(), fm)
    post = mean((out.postnet_mel - tgt).abs(), fm)
    pitch = mean((out.p_pred - batch["p_targets"]) ** 2, out.src_valid)
    energy = mean((out.e_pred - batch["e_targets"]) ** 2, out.src_valid)
    dur = mean((out.log_d_pred - torch.log(batch["d_targets"].float() + 1.0)) ** 2, out.src_valid)
    return (mel + post + dur + pitch + energy, mel, post, pitch, energy, dur)


# ------------------------------------------------------------------ MelGAN

def _reflect_conv(x, P, name, q, dilation=1):
    w = P[name + ".weight"]
    pad = dilation * (w.shape[-1] - 1) // 2
    if pad:
        x = F.pad(x, (pad, pad), mode="reflect")
    return F.conv1d(q(x), q(w), None, dilation=dilation) + P[name + ".bias"][:, None]


def _conv1x1(x, P, name, q):
    return F.conv1d(q(x), q(P[name + ".weight"]), None) + P[name + ".bias"][:, None]


def melgan(P, mel, q=FP32.v, pre_tanh=False):
    """(B, T, 80) natural-log mel -> (B, T * 256) waveform in [-1, 1] (or
    the output convolution's values before the tanh)."""
    x = _reflect_conv((mel / math.log(10.0)).transpose(1, 2), P, "conv_in", q)
    for i, r in enumerate(MELGAN_RATIOS):
        x = F.leaky_relu(x, LEAKY)
        w = P[f"ups.{i}.convt.weight"]
        x = F.conv_transpose1d(q(x), q(w), None, stride=r, padding=r // 2 + r % 2) \
            + P[f"ups.{i}.convt.bias"][:, None]
        for j, d in enumerate(MELGAN_DILATIONS):
            b = f"ups.{i}.blocks.{j}"
            h = _reflect_conv(F.leaky_relu(x, LEAKY), P, b + ".conv_d", q, d)
            h = _conv1x1(F.leaky_relu(h, LEAKY), P, b + ".conv_1", q)
            x = _conv1x1(x, P, b + ".shortcut", q) + h
    x = _reflect_conv(F.leaky_relu(x, LEAKY), P, "conv_out", q)
    return x[:, 0] if pre_tanh else torch.tanh(x)[:, 0]
