"""FastSpeech2 loss (reference ``lightning/model/loss.py:5-92``).

Masked means are sum(err * mask) / max(sum(mask), 1), all in fp32, as in
the JAX package: the reference's masked_select + mean at static shapes.
On a rank's shard of a flat batch (``parallel.distributed.row_shard``) the
denominator is the whole batch's valid count, so the ranks' losses sum to
the whole batch's.
"""

from typing import Any, NamedTuple

import torch

from ..parallel.distributed import current_row_shard, global_sum


class LossValues(NamedTuple):
    total: Any
    mel: Any
    postnet_mel: Any
    pitch: Any
    energy: Any
    duration: Any

    def to_dict(self, prefix=""):
        return {prefix + k: v for k, v in zip(self._fields, self)}


def _masked_mean(err, mask):
    m = mask.float()
    den = m.sum()
    shard = current_row_shard()
    if shard is not None:
        den = global_sum(den.detach())
    return (err * m).sum() / den.clamp_min(1.0)


def _masked_l1(pred, target, mask):
    return _masked_mean((pred.float() - target.float()).abs(), mask)


def _masked_mse(pred, target, mask):
    return _masked_mean((pred.float() - target.float()) ** 2, mask)


def fastspeech2_loss(batch, output, preprocess_cfg):
    """batch: ``data.collate.Batch``; output: ``FS2Output`` -> LossValues."""
    pp = preprocess_cfg["preprocessing"]
    src_valid, mel_valid = output.src_valid, output.mel_valid
    mel_targets = batch.mels[:, :output.mel.shape[1]]

    mel_loss = _masked_l1(output.mel, mel_targets, mel_valid[..., None])
    postnet_loss = _masked_l1(output.postnet_mel, mel_targets,
                              mel_valid[..., None])
    pitch_mask = src_valid if pp["pitch"]["feature"] == "phoneme_level" else mel_valid
    energy_mask = src_valid if pp["energy"]["feature"] == "phoneme_level" else mel_valid
    pitch_loss = _masked_mse(output.p_pred, batch.p_targets, pitch_mask)
    energy_loss = _masked_mse(output.e_pred, batch.e_targets, energy_mask)
    log_d_targets = torch.log(batch.d_targets.float() + 1.0)
    duration_loss = _masked_mse(output.log_d_pred, log_d_targets, src_valid)

    total = mel_loss + postnet_loss + duration_loss + pitch_loss + energy_loss
    return LossValues(total, mel_loss, postnet_loss, pitch_loss, energy_loss,
                      duration_loss)
