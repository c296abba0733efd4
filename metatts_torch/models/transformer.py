"""FFT-block transformer encoder/decoder and postnet (FastSpeech2 backbone).

An FFT block is post-LN multi-head self-attention followed by a conv(k, 1)
FFN, with outputs zeroed at padded positions.  In eval mode with the fused
path requested (the serving engine requests it) and a supported width, each
block runs as one ``ops/fftblock.fused_fft_block`` call; otherwise the
plain PyTorch block below runs, attention as materialised (B, h, T, T)
scores.
"""

import math

import numpy as np
import torch
from torch import nn

from . import nn as L
from ..ops.fftblock import (fused_block_supported, fused_fft_block,
                            pack_block_params)
from ..text.symbols import symbols


def sinusoid_table(n_position, d_hid):
    """Reference ``Models.py:10-30``; numpy (n_position, d_hid) fp32."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class _Precision:
    """Compute, scores and activation dtypes of a model config."""

    def __init__(self, cfg):
        self.cdtype = L.dtype(cfg.get("compute_dtype", "float32"))
        self.sdtype = L.dtype(cfg.get("attention_scores_dtype", "float32"))
        self.adtype = L.dtype(cfg.get("activation_dtype", "float32"))


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model, n_head, d_k):
        super().__init__()
        self.w_qs = L.Linear(d_model, n_head * d_k)
        self.w_ks = L.Linear(d_model, n_head * d_k)
        self.w_vs = L.Linear(d_model, n_head * d_k)
        self.fc = L.Linear(n_head * d_k, d_model)
        self.layer_norm = L.LayerNorm(d_model)

    def forward(self, x, key_valid, n_head, prec):
        """Self-attention, post-LN residual.  key_valid: (B, T) bool."""
        B, T, _ = x.shape
        cd, ad = prec.cdtype, prec.adtype
        d_k = self.w_qs.weight.shape[0] // n_head
        q = self.w_qs(x, cd, ad).view(B, T, n_head, d_k)
        k = self.w_ks(x, cd, ad).view(B, T, n_head, d_k)
        v = self.w_vs(x, cd, ad).view(B, T, n_head, d_k)
        # scale folded into q in the compute dtype, as the JAX package does
        scale = torch.tensor(1.0 / math.sqrt(d_k), dtype=cd, device=x.device)
        scores = torch.einsum("bqhd,bkhd->bhqk", (q.to(cd) * scale).float(),
                              L.round_to(k, cd)).to(prec.sdtype)
        scores = torch.where(key_valid[:, None, None, :], scores,
                             torch.tensor(-1e9, dtype=prec.sdtype,
                                          device=x.device))
        attn = torch.softmax(scores.float(), dim=-1).to(prec.sdtype)
        out = torch.einsum("bhqk,bkhd->bqhd", L.round_to(attn, cd),
                           L.round_to(v, cd))
        out = self.fc(out.reshape(B, T, n_head * d_k), cd, ad)
        return self.layer_norm(out + x, ad)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model, d_inner, kernel_sizes):
        super().__init__()
        self.w_1 = L.Conv1d(d_model, d_inner, kernel_sizes[0])
        self.w_2 = L.Conv1d(d_inner, d_model, kernel_sizes[1])
        self.layer_norm = L.LayerNorm(d_model)

    def forward(self, x, prec):
        h = torch.relu(self.w_1(x, prec.cdtype, out_dtype=prec.adtype))
        h = self.w_2(h, prec.cdtype, out_dtype=prec.adtype)
        return self.layer_norm(h + x, prec.adtype)


class FFTBlock(nn.Module):
    def __init__(self, d_model, n_head, d_inner, kernel_sizes):
        super().__init__()
        self.slf_attn = MultiHeadAttention(d_model, n_head, d_model // n_head)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_sizes)
        self._packed = (None, None)

    def forward(self, x, valid, n_head, prec):
        keep = valid[..., None]
        x = self.slf_attn(x, valid, n_head, prec)
        x = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
        x = self.pos_ffn(x, prec)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))

    def fused_params(self):
        """``pack_block_params`` of this block, repacked only after a
        parameter changed (in place or by moving the module)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._packed[0] != key:
            with torch.no_grad():
                self._packed = (key, pack_block_params(self.slf_attn,
                                                       self.pos_ffn))
        return self._packed[1]


def _use_fused_infer(fused_infer, training, d_model, n_head):
    """Fused FFT-block gate: requested by the caller (the serving engine),
    eval mode, and a width the kernel takes.  The kernel has no backward,
    so a training forward never takes it."""
    return (bool(fused_infer) and not training
            and fused_block_supported(d_model, d_model // n_head))


class _Stack(nn.Module):
    def __init__(self, cfg, d, n_head, n_layer):
        super().__init__()
        t = cfg["transformer"]
        self.n_head = n_head
        self.prec = _Precision(cfg)
        self.layer_stack = nn.ModuleList([
            FFTBlock(d, n_head, t["conv_filter_size"], t["conv_kernel_size"])
            for _ in range(n_layer)])

    def _run(self, x, valid, fused_infer):
        d = x.shape[-1]
        if _use_fused_infer(fused_infer, self.training, d, self.n_head):
            for layer in self.layer_stack:
                x = fused_fft_block(layer.fused_params(), x, valid,
                                    self.n_head).to(self.prec.adtype)
            return x
        for layer in self.layer_stack:
            x = layer(x, valid, self.n_head, self.prec)
        return x


class Encoder(_Stack):
    def __init__(self, cfg):
        t = cfg["transformer"]
        super().__init__(cfg, t["encoder_hidden"], t["encoder_head"],
                         t["encoder_layer"])
        self.src_word_emb = L.Embedding(len(symbols) + 1, t["encoder_hidden"],
                                        padding_row=0)

    def forward(self, texts, src_valid, pos_table, fused_infer=False):
        """texts: (B, L) int -> (B, L, H) in the activation dtype."""
        n = texts.shape[1]
        x = (self.src_word_emb(texts) + pos_table[None, :n]).to(self.prec.adtype)
        return self._run(x, src_valid, fused_infer)


class Decoder(_Stack):
    def __init__(self, cfg):
        t = cfg["transformer"]
        super().__init__(cfg, t["decoder_hidden"], t["decoder_head"],
                         t["decoder_layer"])

    def forward(self, x, mel_valid, pos_table, fused_infer=False):
        n = x.shape[1]
        x = (x + pos_table[None, :n]).to(self.prec.adtype)
        return self._run(x, mel_valid, fused_infer)


class ConvNorm(nn.Module):
    def __init__(self, c_in, c_out, k):
        super().__init__()
        self.conv = L.Conv1d(c_in, c_out, k)

    def forward(self, x, cdtype=torch.float32):
        return self.conv(x, cdtype)


class PostNet(nn.Module):
    """5-conv residual refiner (reference ``Layers.py:67-137``)."""

    def __init__(self, n_mels=80, d=512, k=5, n_convs=5):
        super().__init__()
        chans = [n_mels] + [d] * (n_convs - 1) + [n_mels]
        self.convolutions = nn.ModuleList([
            nn.ModuleList([ConvNorm(chans[i], chans[i + 1], k),
                           L.BatchNorm(chans[i + 1])])
            for i in range(n_convs)])

    def forward(self, mel, cdtype=torch.float32):
        """mel: (B, T, n_mels) -> residual (B, T, n_mels) fp32."""
        x = mel
        n = len(self.convolutions)
        for i, (conv, bn) in enumerate(self.convolutions):
            x = bn(conv(x, cdtype))
            if i < n - 1:
                x = torch.tanh(x)
        return x
