"""Variance adaptor: duration / pitch / energy prediction + length regulation
(reference ``lightning/model/modules.py:17-250``).

Pitch/energy bins come from corpus ``stats.json`` and are buffers;
``torch.bucketize(right=False)`` is the left-sided search of the bins.
"""

import numpy as np
import torch
from torch import nn

from . import nn as L
from .transformer import ConvNorm
from ..ops.length_regulator import length_regulate
from ..utils.tools import get_mask_from_lengths


class VariancePredictor(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["transformer"]["encoder_hidden"]
        v = cfg["variance_predictor"]
        f, k = v["filter_size"], v["kernel_size"]
        self.conv_layer = nn.ModuleDict({
            "conv1d_1": ConvNorm(d, f, k),
            "layer_norm_1": L.LayerNorm(f),
            "conv1d_2": ConvNorm(f, f, k),
            "layer_norm_2": L.LayerNorm(f),
        })
        self.linear_layer = L.Linear(f, 1)

    def forward(self, x, valid, cdtype, *, drop_rate=0.0, train=False,
                seed=None):
        c = self.conv_layer
        r1, r2 = L.split(seed, 2)
        h = torch.relu(c["conv1d_1"](x, cdtype))
        h = L.dropout(c["layer_norm_1"](h), drop_rate, train,
                      L.generator(r1, x.device))
        h = torch.relu(c["conv1d_2"](h, cdtype))
        h = L.dropout(c["layer_norm_2"](h), drop_rate, train,
                      L.generator(r2, x.device))
        out = self.linear_layer(h, cdtype)[..., 0]
        return torch.where(valid, out, torch.zeros((), device=out.device))


def make_bins(lo, hi, n_bins, quantization):
    if quantization == "log":
        return np.exp(np.linspace(np.log(lo), np.log(hi), n_bins - 1)) \
            .astype(np.float32)
    return np.linspace(lo, hi, n_bins - 1).astype(np.float32)


class VarianceAdaptor(nn.Module):
    def __init__(self, model_cfg, preprocess_cfg, stats):
        """stats: 'pitch' / 'energy' -> [min, max, mean, std] (stats.json)."""
        super().__init__()
        ve = model_cfg["variance_embedding"]
        d = model_cfg["transformer"]["encoder_hidden"]
        n_bins = ve["n_bins"]
        pp = preprocess_cfg["preprocessing"]
        self.pitch_level = pp["pitch"]["feature"]
        self.energy_level = pp["energy"]["feature"]
        self.cdtype = L.dtype(model_cfg.get("compute_dtype", "float32"))
        self.drop_rate = model_cfg["variance_predictor"]["dropout"]
        self.duration_predictor = VariancePredictor(model_cfg)
        self.pitch_predictor = VariancePredictor(model_cfg)
        self.energy_predictor = VariancePredictor(model_cfg)
        self.pitch_embedding = L.Embedding(n_bins, d)
        self.energy_embedding = L.Embedding(n_bins, d)
        self.register_buffer("pitch_bins", torch.from_numpy(make_bins(
            stats["pitch"][0], stats["pitch"][1], n_bins,
            ve["pitch_quantization"])))
        self.register_buffer("energy_bins", torch.from_numpy(make_bins(
            stats["energy"][0], stats["energy"][1], n_bins,
            ve["energy_quantization"])))

    def _add_variance(self, predictor, embedding, bins, target, control,
                      valid, h, train, seed):
        pred = predictor(h, valid, self.cdtype, drop_rate=self.drop_rate,
                         train=train, seed=seed)
        if target is not None:
            value = target
        else:
            pred = pred * control
            value = pred
        emb = embedding(torch.bucketize(value.contiguous(), bins, right=False))
        return pred, h + emb

    def forward(self, x, src_valid, *, max_mel_len, mel_valid=None,
                p_targets=None, e_targets=None, d_targets=None,
                p_control=1.0, e_control=1.0, d_control=1.0, train=None,
                seed=None):
        """Returns (x_expanded, p_pred, e_pred, log_d_pred, d_rounded,
        mel_lens, mel_valid): teacher-forced when targets are given,
        predicted otherwise (reference ``modules.py:102-159``).  In training
        (default: the module's mode) the predictors take dropout, each from
        its own seed, folded from ``seed`` in the order they run."""
        train = self.training if train is None else train
        seeds = iter(L.split(seed, 4))
        log_d_pred = self.duration_predictor(
            x, src_valid, self.cdtype, drop_rate=self.drop_rate, train=train,
            seed=next(seeds))
        pitch = (self.pitch_predictor, self.pitch_embedding, self.pitch_bins,
                 p_targets, p_control)
        energy = (self.energy_predictor, self.energy_embedding,
                  self.energy_bins, e_targets, e_control)

        p_pred = e_pred = None
        if self.pitch_level == "phoneme_level":
            p_pred, x = self._add_variance(*pitch, src_valid, x, train, next(seeds))
        if self.energy_level == "phoneme_level":
            e_pred, x = self._add_variance(*energy, src_valid, x, train, next(seeds))

        if d_targets is not None:
            d_rounded = d_targets
            x, mel_lens = length_regulate(x, d_targets, max_mel_len)
        else:
            # round half to even, then the control, then truncation to int
            d = torch.round(torch.exp(log_d_pred) - 1.0) * d_control
            d_rounded = d.clamp(min=0.0).to(torch.int32)
            d_rounded = torch.where(src_valid, d_rounded,
                                    torch.zeros((), dtype=torch.int32,
                                                device=x.device))
            x, mel_lens = length_regulate(x, d_rounded, max_mel_len)
            mel_valid = get_mask_from_lengths(mel_lens, max_mel_len)

        if self.pitch_level == "frame_level":
            p_pred, x = self._add_variance(*pitch, mel_valid, x, train, next(seeds))
        if self.energy_level == "frame_level":
            e_pred, x = self._add_variance(*energy, mel_valid, x, train, next(seeds))

        return x, p_pred, e_pred, log_d_pred, d_rounded, mel_lens, mel_valid
