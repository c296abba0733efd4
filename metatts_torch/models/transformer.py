"""FFT-block transformer encoder/decoder and postnet (FastSpeech2 backbone).

An FFT block is post-LN multi-head self-attention followed by a conv(k, 1)
FFN, with outputs zeroed at padded positions and, in training, dropout
after the attention output projection and after the FFN.  In eval mode
with the fused path requested (the serving engine requests it) and a
supported width, each block runs as one ``ops/fftblock.fused_fft_block``
call.  Otherwise attention runs as one of (``attention_impl``):

* ``"einsum"``: materialised (B, h, T, T) scores, differentiable any number
  of times;
* ``"einsum_remat"``: the same, with the scores recomputed in the backward
  (``torch.utils.checkpoint``, non-reentrant, so double backward works);
* ``"flash"``: the flash-attention kernel of ``ops/attention.py``,
  differentiable once;
* ``"auto"``: flash on a CUDA tensor, einsum elsewhere.
"""

import functools
import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import nn as L
from ..ops.attention import flash_attention
from ..ops.fftblock import (fused_block_supported, fused_fft_block,
                            pack_block_params)
from ..text.symbols import symbols

ATTENTION_IMPLS = ("flash", "einsum", "einsum_remat", "auto")


def sinusoid_table(n_position, d_hid):
    """Reference ``Models.py:10-30``; numpy (n_position, d_hid) fp32."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def resolve_attn_impl(impl, device):
    """``attention_impl`` -> the one that runs: "auto" is flash on a CUDA
    tensor (the JAX package's flash-on-TPU) and einsum elsewhere."""
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl {impl!r}: expected one of {ATTENTION_IMPLS}")
    if impl == "auto":
        return "flash" if torch.device(device).type == "cuda" else "einsum"
    return impl


def softmax(s):
    """Softmax over the last axis, rounding where JAX's does: in bf16 the
    shift by the row max, the exp and the division round to bf16 and the
    row sum accumulates in fp32 before its rounding.  The max is a constant
    of the gradient (softmax does not depend on it)."""
    if s.dtype == torch.float32:
        return torch.softmax(s, -1)
    e = torch.exp(s - s.amax(-1, keepdim=True).detach())
    return e / e.float().sum(-1, keepdim=True).to(s.dtype)


def _attn_core(q, k, v, valid, prec):
    """Materialised masked attention of (B, T, h, d) q, k, v -> fp32."""
    cd, sd = prec.cdtype, prec.sdtype
    # scale folded into q in the compute dtype, as the JAX package does
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=cd, device=q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", (q.to(cd) * scale).float(),
                          L.round_to(k, cd)).to(sd)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(-1e9, dtype=sd, device=q.device))
    return torch.einsum("bhqk,bkhd->bqhd", L.round_to(softmax(scores), cd),
                        L.round_to(v, cd))


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

    def forward(self, x, key_valid, n_head, prec, *, attn_impl="einsum",
                drop_rate=0.0, train=False, seed=None):
        """Self-attention, post-LN residual.  key_valid: (B, T) bool;
        attn_impl: flash | einsum | einsum_remat (resolved)."""
        B, T, _ = x.shape
        cd, ad = prec.cdtype, prec.adtype
        d_k = self.w_qs.weight.shape[0] // n_head
        q = self.w_qs(x, cd, ad).view(B, T, n_head, d_k)
        k = self.w_ks(x, cd, ad).view(B, T, n_head, d_k)
        v = self.w_vs(x, cd, ad).view(B, T, n_head, d_k)
        if attn_impl == "flash":
            # the kernel takes (B*h, T, d) in the compute dtype
            fold = lambda t: t.transpose(1, 2).reshape(B * n_head, T, d_k).to(cd)
            mask = key_valid.float().repeat_interleave(n_head, 0)
            out = flash_attention(fold(q), fold(k), fold(v), mask)
            out = out.view(B, n_head, T, d_k).transpose(1, 2)
        elif attn_impl == "einsum_remat":
            out = checkpoint(functools.partial(_attn_core, prec=prec),
                             q, k, v, key_valid, use_reentrant=False)
        elif attn_impl == "einsum":
            out = _attn_core(q, k, v, key_valid, prec)
        else:
            raise ValueError(f"attn_impl {attn_impl!r}")
        out = self.fc(out.reshape(B, T, n_head * d_k), cd, ad)
        out = L.dropout(out, drop_rate, train, L.generator(seed, x.device))
        return self.layer_norm(out + x, ad)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model, d_inner, kernel_sizes):
        super().__init__()
        self.w_1 = L.Conv1d(d_model, d_inner, kernel_sizes[0])
        self.w_2 = L.Conv1d(d_inner, d_model, kernel_sizes[1])
        self.layer_norm = L.LayerNorm(d_model)

    def forward(self, x, prec, *, drop_rate=0.0, train=False, seed=None):
        h = torch.relu(self.w_1(x, prec.cdtype, out_dtype=prec.adtype))
        h = self.w_2(h, prec.cdtype, out_dtype=prec.adtype)
        h = L.dropout(h, drop_rate, train, L.generator(seed, x.device))
        return self.layer_norm(h + x, prec.adtype)


class FFTBlock(nn.Module):
    def __init__(self, d_model, n_head, d_inner, kernel_sizes):
        super().__init__()
        self.slf_attn = MultiHeadAttention(d_model, n_head, d_model // n_head)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_sizes)
        self._packed = ((), (), None)

    def forward(self, x, valid, n_head, prec, *, attn_impl="einsum",
                drop_rate=0.0, train=False, seed=None):
        keep = valid[..., None]
        r1, r2 = L.split(seed, 2)
        x = self.slf_attn(x, valid, n_head, prec, attn_impl=attn_impl,
                          drop_rate=drop_rate, train=train, seed=r1)
        x = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
        x = self.pos_ffn(x, prec, drop_rate=drop_rate, train=train, seed=r2)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))

    def __getstate__(self):
        # a copy (deepcopy, pickle) packs again at its first fused call: the
        # pack holds this block's tensors and the kernel's C pointers to them
        return {**self.__dict__, "_packed": ((), (), None)}

    def fused_params(self):
        """``pack_block_params`` of this block, repacked unless every
        parameter is the very tensor of the last pack at the same version.
        The pack holds its source tensors, so a freed tensor's address
        reused by another (a parameter dict swapped in by
        ``functional_call``, then freed) cannot pass for it."""
        sources = tuple(self.parameters())
        versions = tuple(p._version for p in sources)
        held, held_versions, pack = self._packed
        if (len(held) != len(sources) or versions != held_versions
                or any(a is not b for a, b in zip(held, sources))):
            with torch.no_grad():
                pack = pack_block_params(self.slf_attn, self.pos_ffn)
            self._packed = (sources, versions, pack)
        return pack


def _use_fused_infer(fused_infer, training, d_model, n_head):
    """Fused FFT-block gate: requested by the caller (the serving engine),
    eval mode, and a width the kernel takes.  The kernel has no backward,
    so a training forward never takes it."""
    return (bool(fused_infer) and not training
            and fused_block_supported(d_model, d_model // n_head))


class _Stack(nn.Module):
    def __init__(self, cfg, d, n_head, n_layer, drop_rate):
        super().__init__()
        t = cfg["transformer"]
        self.n_head = n_head
        self.drop_rate = drop_rate
        self.attn_impl = cfg.get("attention_impl", "auto")
        self.prec = _Precision(cfg)
        self.layer_stack = nn.ModuleList([
            FFTBlock(d, n_head, t["conv_filter_size"], t["conv_kernel_size"])
            for _ in range(n_layer)])

    def _run(self, x, valid, fused_infer, train, seed, attn_impl):
        d = x.shape[-1]
        train = self.training if train is None else train
        if _use_fused_infer(fused_infer, train, d, self.n_head):
            for layer in self.layer_stack:
                x = fused_fft_block(layer.fused_params(), x, valid,
                                    self.n_head, out_dtype=self.prec.adtype)
            return x
        impl = resolve_attn_impl(attn_impl or self.attn_impl, x.device)
        for i, layer in enumerate(self.layer_stack):
            x = layer(x, valid, self.n_head, self.prec, attn_impl=impl,
                      drop_rate=self.drop_rate, train=train,
                      seed=None if seed is None else L.fold_in(seed, i))
        return x


class Encoder(_Stack):
    def __init__(self, cfg):
        t = cfg["transformer"]
        super().__init__(cfg, t["encoder_hidden"], t["encoder_head"],
                         t["encoder_layer"], t["encoder_dropout"])
        self.src_word_emb = L.Embedding(len(symbols) + 1, t["encoder_hidden"],
                                        padding_row=0)

    def forward(self, texts, src_valid, pos_table, fused_infer=False, *,
                train=None, seed=None, attn_impl=None):
        """texts: (B, L) int -> (B, L, H) in the activation dtype.  train
        defaults to the module's mode, attn_impl to the config's."""
        n = texts.shape[1]
        x = (self.src_word_emb(texts) + pos_table[None, :n]).to(self.prec.adtype)
        return self._run(x, src_valid, fused_infer, train, seed, attn_impl)


class Decoder(_Stack):
    def __init__(self, cfg):
        t = cfg["transformer"]
        super().__init__(cfg, t["decoder_hidden"], t["decoder_head"],
                         t["decoder_layer"], t["decoder_dropout"])

    def forward(self, x, mel_valid, pos_table, fused_infer=False, *,
                train=None, seed=None, attn_impl=None):
        n = x.shape[1]
        x = (x + pos_table[None, :n]).to(self.prec.adtype)
        return self._run(x, mel_valid, fused_infer, train, seed, attn_impl)


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

    def forward(self, mel, cdtype=torch.float32, *, train=None, seed=None,
                update_bn_state=True):
        """mel: (B, T, n_mels) -> residual (B, T, n_mels) fp32.  In training
        the BatchNorms use batch statistics and each conv's output takes
        dropout 0.5; ``update_bn_state=False`` leaves the running
        statistics as they are."""
        train = self.training if train is None else train
        x = mel
        n = len(self.convolutions)
        for i, (conv, bn) in enumerate(self.convolutions):
            x = bn(conv(x, cdtype), train, update_bn_state)
            if i < n - 1:
                x = torch.tanh(x)
            lseed = None if seed is None else L.fold_in(seed, i)
            x = L.dropout(x, 0.5, train, L.generator(lseed, x.device))
        return x
