"""Neural vocoders: MelGAN and HiFi-GAN generators (mel -> waveform).

  MelGAN (descriptinc/melgan-neurips, ngf=32, hop 256):
    conv7(80->512) -> [upsample x8, x8, x2, x2; each = leaky_relu +
    convT(k=2r, s=r) + 3 residual blocks (dilations 1, 3, 9)] -> conv7 -> tanh
    (reflection padding on every k>1 conv, as the official generator)
  HiFi-GAN (jik876, config v1):
    conv7(80->512) -> [convT upsample (8,8,2,2) + MRF resblocks
    k=(3,7,11) d=((1,3,5),)x3] -> conv7 -> tanh

Input mel is natural-log scale, divided by ln(10) for MelGAN (the
reference's convention); output is float in [-1, 1], scaled to int16 by
``max_wav_value``.  Module names mirror the JAX package's parameter tree;
``*_params_from_npz`` map the official generators' state dicts onto them.
Both run in fp32 internally on (B, C, T).
"""

import math
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import nn as L

LEAKY = 0.2

MELGAN_RATIOS = (8, 8, 2, 2)
MELGAN_NGF = 32
MELGAN_DILATIONS = (1, 3, 9)

HIFIGAN_UPSAMPLE_RATES = (8, 8, 2, 2)
HIFIGAN_UPSAMPLE_KERNELS = (16, 16, 4, 4)
HIFIGAN_RESBLOCK_KERNELS = (3, 7, 11)
HIFIGAN_RESBLOCK_DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
HIFIGAN_LRELU = 0.1  # official LRELU_SLOPE; the final activation uses 0.01


def _reflect_conv(m, x, cdtype, dilation=1):
    """Conv over (B, C, T) with reflection padding (k > 1) of the official
    generator's ``nn.ReflectionPad1d``."""
    pad = dilation * (m.weight.shape[-1] - 1) // 2
    if pad:
        x = F.pad(x, (pad, pad), mode="reflect")
    return L.conv1d_nct(m, x, cdtype, dilation)


class _MelGANBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv_d = L.Conv1d(c, c, 3)
        self.conv_1 = L.Conv1d(c, c, 1)
        self.shortcut = L.Conv1d(c, c, 1)


class _MelGANUp(nn.Module):
    def __init__(self, c_in, c_out, r):
        super().__init__()
        self.convt = L.ConvTranspose1d(c_in, c_out, 2 * r)
        self.blocks = nn.ModuleList([_MelGANBlock(c_out)
                                     for _ in MELGAN_DILATIONS])


class MelGAN(nn.Module):
    def __init__(self, n_mels=80, ngf=MELGAN_NGF, ratios=MELGAN_RATIOS):
        super().__init__()
        mult = int(2 ** len(ratios))
        self.conv_in = L.Conv1d(n_mels, mult * ngf, 7)
        ups = []
        for r in ratios:
            ups.append(_MelGANUp(mult * ngf, mult * ngf // 2, r))
            mult //= 2
        self.ups = nn.ModuleList(ups)
        self.conv_out = L.Conv1d(ngf, 1, 7)

    def forward(self, mel, cdtype=torch.float32):
        """mel: (B, T, n_mels) natural-log mel -> (B, T*256) wav in [-1,1]."""
        x = (mel / math.log(10.0)).transpose(1, 2)
        x = _reflect_conv(self.conv_in, x, cdtype)
        for up, r in zip(self.ups, MELGAN_RATIOS):
            x = F.leaky_relu(x, LEAKY)
            x = up.convt(x, stride=r, cdtype=cdtype, padding=r // 2 + r % 2)
            for blk, d in zip(up.blocks, MELGAN_DILATIONS):
                h = F.leaky_relu(x, LEAKY)
                h = _reflect_conv(blk.conv_d, h, cdtype, dilation=d)
                h = F.leaky_relu(h, LEAKY)
                h = L.conv1d_nct(blk.conv_1, h, cdtype)
                x = L.conv1d_nct(blk.shortcut, x, cdtype) + h
        x = F.leaky_relu(x, LEAKY)
        x = _reflect_conv(self.conv_out, x, cdtype)
        return torch.tanh(x)[:, 0]


def _conv_sd(w, base, name):
    out = {f"{name}.weight": np.array(w[f"{base}.weight"])}
    if f"{base}.bias" in w:
        out[f"{name}.bias"] = np.array(w[f"{base}.bias"])
    return out


def melgan_params_from_npz(w):
    """State dict of ``MelGAN`` from the descriptinc melgan-neurips
    generator's (official ``model.<idx>`` nn.Sequential layout, weight-norm
    folded).  Sequential indices: 0 ReflectionPad, 1 conv_in; per upsample
    ratio [LeakyReLU, ConvTranspose1d, ResnetBlock x3]; then LeakyReLU,
    ReflectionPad, conv_out, Tanh.  ResnetBlock children: ``block.2``
    (dilated k3), ``block.4`` (k1), ``shortcut`` (k1)."""
    sd = _conv_sd(w, "model.1", "conv_in")
    idx = 2
    for i in range(len(MELGAN_RATIOS)):
        sd.update(_conv_sd(w, f"model.{idx + 1}", f"ups.{i}.convt"))
        for j in range(len(MELGAN_DILATIONS)):
            b = idx + 2 + j
            sd.update(_conv_sd(w, f"model.{b}.block.2", f"ups.{i}.blocks.{j}.conv_d"))
            sd.update(_conv_sd(w, f"model.{b}.block.4", f"ups.{i}.blocks.{j}.conv_1"))
            sd.update(_conv_sd(w, f"model.{b}.shortcut", f"ups.{i}.blocks.{j}.shortcut"))
        idx += 2 + len(MELGAN_DILATIONS)
    sd.update(_conv_sd(w, f"model.{idx + 2}", "conv_out"))
    return {k: torch.from_numpy(v) for k, v in sd.items()}


class _HiFiRes(nn.Module):
    def __init__(self, c, k, n):
        super().__init__()
        self.convs1 = nn.ModuleList([L.Conv1d(c, c, k) for _ in range(n)])
        self.convs2 = nn.ModuleList([L.Conv1d(c, c, k) for _ in range(n)])


class _HiFiUp(nn.Module):
    def __init__(self, c_in, c_out, k):
        super().__init__()
        self.convt = L.ConvTranspose1d(c_in, c_out, k)
        self.res = nn.ModuleList([
            _HiFiRes(c_out, rk, len(rds)) for rk, rds in
            zip(HIFIGAN_RESBLOCK_KERNELS, HIFIGAN_RESBLOCK_DILATIONS)])


class HiFiGAN(nn.Module):
    def __init__(self, n_mels=80, upsample_initial_channel=512):
        super().__init__()
        self.conv_pre = L.Conv1d(n_mels, upsample_initial_channel, 7)
        ups = []
        c = upsample_initial_channel
        for k in HIFIGAN_UPSAMPLE_KERNELS:
            ups.append(_HiFiUp(c, c // 2, k))
            c //= 2
        self.ups = nn.ModuleList(ups)
        self.conv_post = L.Conv1d(c, 1, 7)

    def forward(self, mel, cdtype=torch.float32):
        """mel: (B, T, n_mels) natural-log mel -> (B, T*256) wav in [-1,1]."""
        x = L.conv1d_nct(self.conv_pre, mel.transpose(1, 2), cdtype, padding=3)
        for up, r, k in zip(self.ups, HIFIGAN_UPSAMPLE_RATES,
                            HIFIGAN_UPSAMPLE_KERNELS):
            x = F.leaky_relu(x, HIFIGAN_LRELU)
            x = up.convt(x, stride=r, cdtype=cdtype, padding=(k - r) // 2)
            acc = None
            for rb, rds in zip(up.res, HIFIGAN_RESBLOCK_DILATIONS):
                h = x
                for c1, c2, d in zip(rb.convs1, rb.convs2, rds):
                    kk = c1.weight.shape[-1]
                    y = F.leaky_relu(h, HIFIGAN_LRELU)
                    y = L.conv1d_nct(c1, y, cdtype, d, padding=d * (kk - 1) // 2)
                    y = F.leaky_relu(y, HIFIGAN_LRELU)
                    y = L.conv1d_nct(c2, y, cdtype, padding=(kk - 1) // 2)
                    h = h + y
                acc = h if acc is None else acc + h
            x = acc / len(up.res)
        x = F.leaky_relu(x, 0.01)
        x = L.conv1d_nct(self.conv_post, x, cdtype, padding=3)
        return torch.tanh(x)[:, 0]


def hifigan_params_from_npz(w):
    """State dict of ``HiFiGAN`` from the jik876 HiFi-GAN v1 generator's
    (``conv_pre / ups.<i> / resblocks.<3i+j>.convs{1,2}.<m> / conv_post``,
    weight-norm folded)."""
    n_res = len(HIFIGAN_RESBLOCK_KERNELS)
    sd = _conv_sd(w, "conv_pre", "conv_pre")
    for i in range(len(HIFIGAN_UPSAMPLE_RATES)):
        sd.update(_conv_sd(w, f"ups.{i}", f"ups.{i}.convt"))
        for j in range(n_res):
            rb = i * n_res + j
            for m in range(len(HIFIGAN_RESBLOCK_DILATIONS[j])):
                for c in ("convs1", "convs2"):
                    sd.update(_conv_sd(w, f"resblocks.{rb}.{c}.{m}",
                                       f"ups.{i}.res.{j}.{c}.{m}"))
    sd.update(_conv_sd(w, "conv_post", "conv_post"))
    return {k: torch.from_numpy(v) for k, v in sd.items()}


class Vocoder:
    """Host wrapper mirroring ``LightningMelGAN.infer``
    (``lightning/utils.py:16-30``)."""

    def __init__(self, model_cfg, n_mels=80, weights_npz=None,
                 generator=None, device="cuda"):
        """``weights_npz``: converted official generator weights (default
        ``model_cfg["vocoder"]["weights_npz"]``).  Without weights the
        generator is random-init from ``generator`` (a CPU
        ``torch.Generator``; seed 0 when None) -- fine for plumbing,
        meaningless audio -- and ``self.pretrained`` records which."""
        self.kind = model_cfg["vocoder"]["model"]
        weights_npz = weights_npz or model_cfg["vocoder"].get("weights_npz")
        loaded = (np.load(weights_npz)
                  if weights_npz and os.path.exists(weights_npz) else None)
        self.pretrained = loaded is not None
        if self.kind == "MelGAN":
            self.net, from_npz = MelGAN(n_mels=n_mels), melgan_params_from_npz
        elif self.kind == "HiFi-GAN":
            self.net, from_npz = HiFiGAN(n_mels=n_mels), hifigan_params_from_npz
        else:
            raise ValueError(f"unknown vocoder {self.kind!r}")
        if loaded is not None:
            self.net.load_state_dict(from_npz(loaded), strict=True)
        else:
            L.reset_parameters(self.net, generator or
                               torch.Generator().manual_seed(0))
            warnings.warn(
                f"{self.kind} vocoder running with RANDOM-INIT weights — "
                "synthesized audio is structurally valid but not speech; "
                "set model.vocoder.weights_npz to converted official "
                "weights", stacklevel=2)
        self.net = self.net.to(device).eval()

    def load_state_dict(self, state_dict):
        self.net.load_state_dict(state_dict, strict=True)

    @torch.no_grad()
    def infer(self, mels, max_wav_value=32768.0, lengths=None):
        """mels (B, T, n_mels) tensor -> list of int16 numpy wavs."""
        dev = next(self.net.parameters()).device
        wavs = self.net(mels.to(dev).float()).cpu().numpy()
        wavs = (wavs * max_wav_value).astype(np.int16)
        out = []
        for i in range(wavs.shape[0]):
            w = wavs[i]
            if lengths is not None:
                w = w[: int(lengths[i])]
            out.append(w)
        return out
