"""The general traffic generator: a traffic mix's data file -> the requests,
batches or episodes of one run, drawn on the host with numpy from ``--seed``.

A mix (``traffic/<name>.json``) names its entry point (the driver
``drivers/<entry>.py``) and its parameters.  A mix with ``"targets"``
draws training targets for each utterance; one with
``"one_speaker_per_unit": true`` gives every utterance of a unit the same
speaker (an episode of one speaker), else each its own.  Utterance lengths
follow a log-normal of the configured mean and spread, cut at a floor and
capped at the configuration's ``max_seq_len`` frames.  A pool of units
(requests, batches or episodes) takes the lengths of the distribution's
equal-probability strata, each stratum at its own conditional mean, so the
mean before the cap is the configured mean for every seed.  With
``"stratify": "unit"`` every unit takes the strata of its own size (all
batches or episodes alike in their sizes); with ``"pool"`` the strata span
the whole pool and are dealt to its units.  The seed deals the lengths in
another order and draws every content (phonemes, speakers, durations,
targets).  A run goes round its pool, so every seed offers the same set of
sizes.
"""

import json
import math
import os
from statistics import NormalDist

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_N = NormalDist()


def load(name, folder=os.path.join(HERE, "traffic")):
    """The traffic mix ``traffic/<name>.json``."""
    with open(os.path.join(folder, name + ".json")) as f:
        return json.load(f)


def rng_for(seed, stream):
    """A numpy generator for one stream of a run: any whole ``seed`` (above
    32 bits too) and a stream name give their own draws."""
    key = [int(b) for b in str(stream).encode()]
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(seed) % 2 ** 128, *key])))


def stratum_means(n, mean, sigma):
    """The conditional means of ``n`` equal-probability strata of a
    log-normal with mean ``mean`` and log-spread ``sigma``: their average is
    ``mean`` exactly (up to rounding)."""
    mu = math.log(mean) - sigma * sigma / 2
    edges = [-math.inf] + [_N.inv_cdf(i / n) for i in range(1, n)] + [math.inf]
    cdf = lambda z: 0.0 if z == -math.inf else 1.0 if z == math.inf else _N.cdf(z)
    scale = math.exp(mu + sigma * sigma / 2) * n
    return np.array([scale * (cdf(b - sigma) - cdf(a - sigma))
                     for a, b in zip(edges[:-1], edges[1:])])


def pool_lengths(mix, frames_per_s, cap, seed):
    """(units, per_unit) utterance lengths in mel frames, before and after
    the floor and the cap: ``(raw, frames)``."""
    lens = mix["lengths"]
    units, per = mix["pool_units"], mix["per_unit"]
    rng = rng_for(seed, "lengths")
    if mix["stratify"] == "unit":
        base = stratum_means(per, lens["mean_s"], lens["sigma"]) * frames_per_s
        raw = np.stack([base[rng.permutation(per)] for _ in range(units)])
    else:
        base = stratum_means(units * per, lens["mean_s"], lens["sigma"]) * frames_per_s
        raw = base[rng.permutation(units * per)].reshape(units, per)
    frames = np.clip(np.rint(raw), round(lens["min_s"] * frames_per_s), cap).astype(np.int64)
    return raw, frames


def _phonemes(rng, frames, mix):
    """(ids, durations) of one utterance of ``frames`` mel frames: its
    phoneme count from the mix's frames a phoneme, every phoneme at least
    one frame, the rest dealt evenly at random."""
    n = max(1, min(int(round(frames / mix["frames_per_phoneme"])), frames))
    lo, hi = mix["phoneme_ids"]
    ids = rng.integers(lo, hi, n).astype(np.int32)
    d = 1 + rng.multinomial(frames - n, np.full(n, 1.0 / n)).astype(np.int32)
    return ids, d


def utterance(rng, frames, mix, speaker, n_mels, with_targets):
    """One sample dict as ``data/collate.py`` takes it.  Targets: a log-mel
    level, a pitch and an energy level of the utterance's own, with noise
    around them, so utterances differ as real ones do."""
    ids, d = _phonemes(rng, frames, mix)
    s = {"id": "", "speaker": int(speaker), "raw_text": "", "text": ids}
    if with_targets:
        t = mix["targets"]
        level = rng.normal(t["mel_level"], t["mel_level_spread"])
        s["mel"] = (level + t["mel_spread"] * rng.standard_normal((frames, n_mels))).astype(np.float32)
        n = len(ids)
        s["pitch"] = (rng.normal(0.0, 1.0) + t["noise"] * rng.standard_normal(n)).astype(np.float32)
        s["energy"] = (rng.normal(0.0, 1.0) + t["noise"] * rng.standard_normal(n)).astype(np.float32)
        s["duration"] = d
    return s


def draw(mix, cfg, seed):
    """The pool of one run: a list of units, each a list of sample dicts
    (a request's sentences, a batch's utterances, or an episode's support
    and then query utterances), and the lengths before the cap."""
    pp = cfg["preprocess"]["preprocessing"]
    frames_per_s = pp["audio"]["sampling_rate"] / pp["stft"]["hop_length"]
    n_mels = pp["mel"]["n_mel_channels"]
    cap = cfg["model"]["max_seq_len"]
    raw, frames = pool_lengths(mix, frames_per_s, cap, seed)
    rng = rng_for(seed, "content")
    n_spk = cfg["n_speakers"]
    targets = "targets" in mix
    units = []
    for row in frames:
        if mix.get("one_speaker_per_unit", False):
            speakers = np.full(len(row), rng.integers(0, n_spk))
        else:
            speakers = rng.integers(0, n_spk, len(row))
        units.append([utterance(rng, int(f), mix, s, n_mels, targets)
                      for f, s in zip(row, speakers)])
    return units, raw


def valid_frames(unit):
    """Mel frames of a unit's utterances, each counted once."""
    return int(sum(len(s["mel"]) for s in unit))
