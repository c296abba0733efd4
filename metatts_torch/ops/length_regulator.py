"""Length regulator: expand phoneme-level features by integer durations.

Frame t of utterance b belongs to phoneme l where

    start[l] = cum[l] - d[l] <= t < cum[l],    cum = cumsum(d),

the (B, T, L) one-hot alignment that the JAX package's
``gather_phoneme_level`` builds.  The expansion is one batched product
``A @ x`` at a static length:

* its value is the JAX package's ``take_along_axis`` bit for bit, in fp32
  and in bf16: each output element is one term plus zeros, and frames at or
  past sum(d) have no term, so they are 0;
* its gradient ``A^T g``, and every higher derivative, is a product whose
  sums run in a fixed order, so a training step repeats itself on the card.
  A gather's backward is a scatter-add, whose CUDA kernel adds with atomics
  in whatever order the threads arrive, and the second-order meta step
  differentiates through it twice.

The product costs B * T * L * H multiply-adds (0.15 G at the train
workload's 5 x 896 frames x 128 phonemes x 256 channels).  Under TF32
matmuls an fp32 ``x`` would be rounded to TF32; the port leaves them off.
"""

import torch


def alignment(durations, n_frames):
    """(B, L) int durations -> (B, n_frames, L) bool, True where frame t
    belongs to phoneme l; frames at or past sum(d) belong to none."""
    cum = torch.cumsum(durations, dim=-1)                     # (B, L)
    starts = cum - durations
    t = torch.arange(n_frames, dtype=cum.dtype, device=cum.device)[None, :, None]
    return (t >= starts[:, None, :]) & (t < cum[:, None, :])


def length_regulate(x, durations, max_mel_len):
    """Expand (B, L, H) by (B, L) int durations -> ((B, T, H), (B,) mel_len)."""
    out = torch.bmm(alignment(durations, max_mel_len).to(x.dtype), x)
    mel_len = durations.sum(-1).clamp(max=max_mel_len).to(torch.int32)
    return out, mel_len


def gather_phoneme_level(frame_feat, durations, src_len=None):
    """Average frame-level (B, T) features to phoneme level (B, L) by
    durations, in fp32: the transpose of ``length_regulate``, used where
    pitch / energy are phoneme-averaged (reference
    ``preprocessor.py:231-261``).  ``src_len`` is implied by
    ``durations.shape[-1]``, as in the JAX package."""
    del src_len
    p = alignment(durations, frame_feat.shape[-1]).float()    # (B, T, L)
    sums = torch.einsum("btl,bt->bl", p, frame_feat.float())
    return sums / durations.float().clamp(min=1.0)
