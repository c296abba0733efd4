"""Collate: sample dicts -> bucketed ``Batch`` of CPU tensors.

Text and mel lengths are rounded up to fixed multiples, so the kernels see
one shape per bucket instead of one per raw length.  Mels ship as fp32.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..utils.tools import pad_1d, pad_2d, bucket_length

TEXT_BUCKET = 32
MEL_BUCKET = 128


class Batch(NamedTuple):
    """Typed equivalent of the reference 12-tuple (``lightning/collate.py``)."""
    speaker_args: Any             # (B,) int32, or (ref_mels, slice_valid)
    texts: Any                    # (B, L) int32
    src_lens: Any                 # (B,) int32
    mels: Optional[Any] = None    # (B, T, n_mels) float32
    mel_lens: Optional[Any] = None
    p_targets: Optional[Any] = None
    e_targets: Optional[Any] = None
    d_targets: Optional[Any] = None

    def to(self, device):
        return map_batch(lambda t: t.to(device), self)


def map_batch(fn, batch):
    """``fn`` applied to every tensor of a Batch, the members of a
    d-vector ``speaker_args`` pair included; None fields stay None."""
    def one(t):
        if t is None:
            return None
        return tuple(fn(x) for x in t) if isinstance(t, tuple) else fn(t)
    return type(batch)(*(one(t) for t in batch))


def stack_batches(batches):
    """Batches -> one Batch stacked on a new leading (episode) axis."""
    def stack(fields):
        if fields[0] is None:
            return None
        if isinstance(fields[0], tuple):
            return tuple(torch.stack(f) for f in zip(*fields))
        return torch.stack(fields)
    return type(batches[0])(*(stack(f) for f in zip(*batches)))


class CollateMeta:
    """Host-side companion of a Batch (ids / raw text)."""

    def __init__(self, ids, raw_texts, speakers):
        self.ids = ids
        self.raw_texts = raw_texts
        self.speakers = speakers


def collate_batch(samples, max_seq_len=1000, with_mels=True,
                  fixed_text_len=None, fixed_mel_len=None, fixed_slices=None):
    """List of dataset sample dicts -> (Batch, CollateMeta).  The text and
    mel lengths are their buckets unless fixed by the caller.  Samples with
    ``spk_ref_mel_slices`` (the d-vector speaker modes) give ``speaker_args
    = (ref (B, S, 160, 40) fp32, valid (B, S) bool)``: each utterance's
    slices zero-padded to S, the most of any sample unless fixed."""
    src_lens = np.array([len(s["text"]) for s in samples], np.int32)
    L = fixed_text_len or bucket_length(int(src_lens.max()), TEXT_BUCKET)
    texts = pad_1d([s["text"] for s in samples], L).astype(np.int32)

    speaker_ids = np.array([s["speaker"] for s in samples], np.int32)
    t = torch.from_numpy
    if "spk_ref_mel_slices" in samples[0]:
        S = fixed_slices or max(s["spk_ref_mel_slices"].shape[0] for s in samples)
        ref = np.zeros((len(samples), S) + samples[0]["spk_ref_mel_slices"].shape[1:],
                       np.float32)
        valid = np.zeros((len(samples), S), bool)
        for i, s in enumerate(samples):
            k = s["spk_ref_mel_slices"].shape[0]
            ref[i, :k] = s["spk_ref_mel_slices"]
            valid[i, :k] = True
        speaker_args = (t(ref), t(valid))
    else:
        speaker_args = t(speaker_ids)
    meta = CollateMeta([s["id"] for s in samples],
                       [s["raw_text"] for s in samples], speaker_ids)

    if not with_mels or "mel" not in samples[0]:
        return Batch(speaker_args=speaker_args, texts=t(texts),
                     src_lens=t(src_lens)), meta

    mel_lens = np.array([s["mel"].shape[0] for s in samples], np.int32)
    T = fixed_mel_len or bucket_length(int(mel_lens.max()), MEL_BUCKET,
                                       max_seq_len)
    mel_lens = np.minimum(mel_lens, T)
    mels = pad_2d([s["mel"] for s in samples], T).astype(np.float32)
    pitches = pad_1d([s["pitch"] for s in samples],
                     L if samples[0]["pitch"].shape[0] == len(samples[0]["text"])
                     else T)
    energies = pad_1d([s["energy"] for s in samples],
                      L if samples[0]["energy"].shape[0] == len(samples[0]["text"])
                      else T)
    durations = pad_1d([s["duration"] for s in samples], L).astype(np.int32)
    # clamp durations so cumulative length fits the mel bucket
    durations = _clamp_durations(durations, mel_lens)

    return Batch(
        speaker_args=speaker_args,
        texts=t(texts),
        src_lens=t(src_lens),
        mels=t(mels),
        mel_lens=t(mel_lens),
        p_targets=t(pitches),
        e_targets=t(energies),
        d_targets=t(durations),
    ), meta


def _clamp_durations(durations, mel_lens):
    """Ensure sum(d) == mel_len per sample (mel may be truncated to bucket)."""
    out = durations.copy()
    for i in range(out.shape[0]):
        cum = np.cumsum(out[i])
        over = cum > mel_lens[i]
        if over.any():
            j = int(np.argmax(over))
            prev = cum[j] - out[i, j]
            out[i, j] = mel_lens[i] - prev
            out[i, j + 1:] = 0
    return out


def collate_episode(sup_samples_list, qry_samples_list, max_seq_len=1000):
    """Lists of per-episode sample lists -> (sup Batch[E, ...], qry
    Batch[E, ...], sup metas, qry metas).  Every episode takes the text and
    mel buckets of the longest utterance of all of them, and in the
    d-vector modes the slice count of the utterance with the most."""
    all_samples = [s for ep in sup_samples_list for s in ep] + \
                  [s for ep in qry_samples_list for s in ep]
    L = bucket_length(max(len(s["text"]) for s in all_samples), TEXT_BUCKET)
    T = bucket_length(max(s["mel"].shape[0] for s in all_samples),
                      MEL_BUCKET, max_seq_len)
    S = (max(s["spk_ref_mel_slices"].shape[0] for s in all_samples)
         if "spk_ref_mel_slices" in all_samples[0] else None)

    def stack(eps):
        pairs = [collate_batch(ep, max_seq_len, fixed_text_len=L, fixed_mel_len=T,
                               fixed_slices=S)
                 for ep in eps]
        return stack_batches([b for b, _ in pairs]), [m for _, m in pairs]

    sup, sup_meta = stack(sup_samples_list)
    qry, qry_meta = stack(qry_samples_list)
    return sup, qry, sup_meta, qry_meta


def split_batch(batch, indices):
    """Re-slice a collated Batch by sample indices (reference
    ``split_reprocess``, ``lightning/collate.py:63-126``) -- inner-loop
    minibatching over a support set."""
    idx = torch.as_tensor(indices, dtype=torch.long)
    return map_batch(lambda t: t[idx.to(t.device)], batch)
