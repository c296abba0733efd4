"""FastSpeech2 acoustic model.

Data flow (reference ``lightning/model/fastspeech2.py:40-112``):
    encoder -> +speaker_emb -> variance adaptor (pitch/energy/duration +
    length regulate) -> +speaker_emb -> decoder -> mel_linear -> +postnet.

Child modules {encoder, speaker_emb, variance_adaptor, decoder, mel_linear,
postnet} are the unit of meta-adaptation, and their parameter names are
the reference's torch state-dict names.
"""

from typing import Any, NamedTuple

import torch
from torch import nn

from . import nn as L
from .speaker_encoder import make_speaker_encoder
from .transformer import Encoder, Decoder, PostNet, sinusoid_table
from .variance_adaptor import VarianceAdaptor
from ..utils.tools import get_mask_from_lengths


class FS2Output(NamedTuple):
    mel: Any
    postnet_mel: Any
    p_pred: Any
    e_pred: Any
    log_d_pred: Any
    d_rounded: Any
    src_valid: Any                # True at valid positions
    mel_valid: Any
    src_lens: Any
    mel_lens: Any


class FastSpeech2(nn.Module):
    def __init__(self, preprocess_cfg, model_cfg, algorithm_cfg, stats,
                 n_speakers, generator=None):
        """``generator``: a CPU ``torch.Generator`` for random init; without
        one the parameters are left for ``load_state_dict``."""
        super().__init__()
        t = model_cfg["transformer"]
        n_mels = preprocess_cfg["preprocessing"]["mel"]["n_mel_channels"]
        self.model_cfg = model_cfg
        self.cdtype = L.dtype(model_cfg.get("compute_dtype", "float32"))
        self.encoder = Encoder(model_cfg)
        self.variance_adaptor = VarianceAdaptor(model_cfg, preprocess_cfg,
                                                stats)
        self.decoder = Decoder(model_cfg)
        self.mel_linear = L.Linear(t["decoder_hidden"], n_mels)
        self.postnet = PostNet(n_mels)
        self.speaker_emb = make_speaker_encoder(model_cfg, algorithm_cfg,
                                                n_speakers)
        if generator is not None:
            L.reset_parameters(self, generator)

    def forward(self, batch, *, train=None, seed=None, attention_impl=None,
                update_bn_state=True, teacher_forced=None, max_mel_len=None,
                p_control=1.0, e_control=1.0, d_control=1.0,
                average_spk_emb=False, fused_infer=None):
        """Forward -> FS2Output.

        train (default: the module's mode) uses batch statistics in the
        postnet's BatchNorms and, given a ``seed``, dropout whose masks all
        derive from that seed (the same seed replays the same masks; no
        seed, no dropout).  ``update_bn_state=False`` leaves the running
        statistics as they are.  attention_impl (default: the config's,
        "auto") is flash | einsum | einsum_remat | auto.
        teacher_forced defaults to "targets present"; pass False to force
        the synthesis path.  max_mel_len caps synthesis length (default: the
        mels' length or ``max_seq_len``).  fused_infer (default: the model
        config's ``_fused_infer``) runs each FFT block of an eval forward as
        one fused kernel.
        """
        cfg = self.model_cfg
        train = self.training if train is None else train
        if fused_infer is None:
            fused_infer = cfg.get("_fused_infer", False)
        if teacher_forced is None:
            teacher_forced = batch.d_targets is not None
        if max_mel_len is None:
            max_mel_len = (batch.mels.shape[1] if batch.mels is not None
                           else cfg["max_seq_len"])
        if train or teacher_forced:
            max_mel_len = min(max_mel_len, cfg["max_seq_len"])

        src_valid = get_mask_from_lengths(batch.src_lens, batch.texts.shape[1])
        mel_valid = (get_mask_from_lengths(batch.mel_lens, max_mel_len)
                     if batch.mel_lens is not None else None)
        device = batch.texts.device
        pos_table = torch.from_numpy(sinusoid_table(
            max(cfg["max_seq_len"], max_mel_len) + 1,
            cfg["transformer"]["encoder_hidden"])).to(device)

        r_enc, r_va, r_dec, r_post = L.split(seed, 4)
        x = self.encoder(batch.texts, src_valid, pos_table, fused_infer,
                         train=train, seed=r_enc, attn_impl=attention_impl)

        spk_emb = None
        if self.speaker_emb is not None:
            spk_emb = self.speaker_emb(batch.speaker_args, self.cdtype)
            if average_spk_emb:
                # query synthesis conditions on the mean support embedding
                spk_emb = spk_emb.mean(0, keepdim=True).expand(
                    x.shape[0], spk_emb.shape[-1])
            elif spk_emb.shape[0] != x.shape[0]:
                raise ValueError("speaker_args batch mismatch")
            x = x + spk_emb[:, None, :]

        (x, p_pred, e_pred, log_d_pred, d_rounded, mel_lens, mel_valid) = \
            self.variance_adaptor(
                x, src_valid, max_mel_len=max_mel_len, mel_valid=mel_valid,
                p_targets=batch.p_targets if teacher_forced else None,
                e_targets=batch.e_targets if teacher_forced else None,
                d_targets=batch.d_targets if teacher_forced else None,
                p_control=p_control, e_control=e_control, d_control=d_control,
                train=train, seed=r_va)

        if spk_emb is not None:
            x = x + spk_emb[:, None, :]

        x = self.decoder(x, mel_valid, pos_table, fused_infer, train=train,
                         seed=r_dec, attn_impl=attention_impl)
        mel = self.mel_linear(x, self.cdtype)
        postnet_mel = mel + self.postnet(mel, self.cdtype, train=train,
                                         seed=r_post,
                                         update_bn_state=update_bn_state)
        return FS2Output(mel, postnet_mel, p_pred, e_pred, log_d_pred,
                         d_rounded, src_valid, mel_valid, batch.src_lens,
                         mel_lens)
