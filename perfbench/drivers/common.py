"""What the drivers share: weights for a model, the reference's own
padding of a unit's samples, and the comparisons that decide ``correct``."""

import math
import statistics
import time

import numpy as np
import torch

from .. import weights as W
from ..reference import model as R

TEXT_BUCKET, MEL_BUCKET = 32, 128


def bucket(n, multiple, cap=None):
    """The system's input bucketing (its collate rounds lengths up to these
    multiples, capped), which the reference's padding follows: training's
    BatchNorm statistics run over every padded frame."""
    b = int(math.ceil(n / multiple) * multiple)
    if cap is not None:
        b = min(b, cap)
    return max(b, multiple)


def pad(samples, device, L=None, T=None, cap=1000):
    """The reference's own batch (a dict of tensors) of sample dicts."""
    n = [len(s["text"]) for s in samples]
    L = L or bucket(max(n), TEXT_BUCKET)
    out = {"texts": np.zeros((len(samples), L), np.int64),
           "src_lens": np.array(n, np.int64),
           "speakers": np.array([s["speaker"] for s in samples], np.int64)}
    for i, s in enumerate(samples):
        out["texts"][i, :n[i]] = s["text"]
    if "mel" in samples[0]:
        m = [len(s["mel"]) for s in samples]
        T = T or bucket(max(m), MEL_BUCKET, cap)
        mels = np.zeros((len(samples), T, samples[0]["mel"].shape[1]), np.float32)
        d = np.zeros((len(samples), L), np.int64)
        p = np.zeros((len(samples), L), np.float32)
        e = np.zeros((len(samples), L), np.float32)
        for i, s in enumerate(samples):
            mels[i, :m[i]] = s["mel"]
            d[i, :n[i]] = s["duration"]
            p[i, :n[i]] = s["pitch"]
            e[i, :n[i]] = s["energy"]
        out.update(mels=mels, mel_lens=np.array(m, np.int64), d_targets=d, p_targets=p,
                   e_targets=e)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def acoustic_weights(module, seed, device):
    """Seeded weights for the acoustic model's parameters."""
    return W.make(dict(module.named_parameters()), weight_seed(seed, "acoustic"), device)


def weight_seed(seed, stream):
    """A seed of its own for each model's weights."""
    return R.fold_in(int(seed) % 2 ** 63, sum(stream.encode()))


def worst_leaf_gap(prog, ref, keep=None):
    """max over leaves of | ||prog|| - ||ref|| | / max(||ref||, median
    leaf ||ref||), over the leaves in ``keep`` (default all); ``prog`` and
    ``ref`` map names to norms."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in ref)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def norms(tensors):
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def with_tf32_off(fn):
    """fn() with TF32 off for matmuls and cuDNN, the flags restored."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    R.no_tf32()
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class Stamp:
    """A point in time on the device's stream: a CUDA event on the card,
    the host clock on the CPU."""

    def __init__(self, device):
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.event, self.t = None, time.perf_counter()

    def ms_to(self, later):
        if self.event is None:
            return 1e3 * (later.t - self.t)
        later.event.synchronize()
        return self.event.elapsed_time(later.event)


def reservoir(rng, k):
    """A seeded sample of ``k`` of a stream of unknown length (Algorithm
    R): ``offer(item)`` returns the item that left the sample (the offered
    one itself, or one it replaced), or None."""
    kept, seen = [], [0]

    def offer(item):
        seen[0] += 1
        if len(kept) < k:
            kept.append(item)
            return None
        j = int(rng.integers(0, seen[0]))
        if j < k:
            kept[j], item = item, kept[j]
        return item
    return kept, offer
