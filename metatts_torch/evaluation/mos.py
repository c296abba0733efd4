"""Pseudo-MOS scorers (reference ``evaluation/compute_mos.py:25,52``).

The reference scores synthesized audio with MOSNet (via the speechmetrics
package), MBNet and a wav2vec2-based predictor: pretrained networks whose
weights are not in the repository.  This module is the registry they plug
into when their converted weights are given (``try_register_*_native``:
``mosnet.py``, ``mbnet.py``, ``wav2vec2.py`` on the card), plus a
spectral-clarity proxy so the pipeline runs end to end without them
(labelled as a proxy, never a substitute for the published numbers).

The TPU package also registers the scorers through their external
packages (speechmetrics, Pytorch_MBNet, transformers); those routes are not
part of the port: the native scorers take the same names.
"""

import math
import os

import numpy as np

_SCORERS = {}


def register_scorer(name):
    def deco(fn):
        _SCORERS[name] = fn
        return fn
    return deco


def available_scorers():
    return sorted(_SCORERS)


# ------------------------------------------------- Student-t quantile

def _betacf(a, b, x):
    """The continued fraction of the regularized incomplete beta function
    (modified Lentz), converging for x < (a + 1) / (a + b + 2)."""
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c, d = 1.0, 1.0 - qab * x / qap
    d = 1.0 / (d if abs(d) > tiny else tiny)
    h = d
    for m in range(1, 1000):
        m2 = 2 * m
        for num in (m * (b - m) * x / ((qam + m2) * (a + m2)),
                    -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))):
            d = 1.0 + num * d
            d = 1.0 / (d if abs(d) > tiny else tiny)
            c = 1.0 + num / c
            c = c if abs(c) > tiny else tiny
            h *= d * c
        if abs(d * c - 1.0) < 1e-16:
            break
    return h


def _betainc(a, b, x):
    """I_x(a, b), the regularized incomplete beta function."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    front = math.exp(math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
                     + a * math.log(x) + b * math.log1p(-x))
    if x < (a + 1.0) / (a + b + 2.0):
        return front * _betacf(a, b, x) / a
    return 1.0 - front * _betacf(b, a, 1.0 - x) / b


def _t_sf(t, df):
    """P(T > t) for t >= 0, Student's t with ``df`` degrees of freedom."""
    return 0.5 * _betainc(df / 2.0, 0.5, df / (df + t * t))


def t_ppf(q, df):
    """The ``q`` quantile (0.5 < q < 1) of Student's t with ``df`` degrees
    of freedom: the root of the tail probability, bracketed, then bisected
    to the last bit."""
    if not 0.5 < q < 1.0:
        raise ValueError(f"t_ppf: q must lie in (0.5, 1), got {q}")
    tail = 1.0 - q
    lo, hi = 0.0, 1.0
    while _t_sf(hi, df) > tail:
        lo, hi = hi, 2.0 * hi
    while True:
        mid = 0.5 * (lo + hi)
        if mid <= lo or mid >= hi:
            return hi if abs(_t_sf(hi, df) - tail) < abs(_t_sf(lo, df) - tail) else lo
        if _t_sf(mid, df) > tail:
            lo = mid
        else:
            hi = mid


def mean_confidence_interval(data, confidence=0.95):
    """Mean and half-width of the t-distribution confidence interval (the
    reference's ``get_mean_confidence_interval``,
    ``evaluation/compute_mos.py:173-178``), used for every MOS row: the
    standard error with ddof 1 times the t quantile at (1 + confidence) / 2."""
    a = np.asarray(data, np.float64)
    n = len(a)
    m = float(np.mean(a))
    if n < 2:
        return m, 0.0
    se = np.std(a, ddof=1) / np.sqrt(n)
    h = float(se * t_ppf((1 + confidence) / 2.0, n - 1))
    return m, h


def score(name, wav, sr):
    if name not in _SCORERS:
        raise KeyError(
            f"MOS scorer {name!r} unavailable (have {available_scorers()}); "
            "MOSNet/MBNet require external pretrained weights")
    return _SCORERS[name](wav, sr)


@register_scorer("spectral_proxy")
def _spectral_proxy(wav, sr):
    """Crude clarity proxy: harmonic-band energy concentration + non-silence
    ratio, mapped to [1, 5]. NOT MOSNet: a plumbing placeholder."""
    wav = np.asarray(wav, np.float64)
    if wav.size < 1024 or not np.isfinite(wav).all():
        return 1.0
    wav = wav / (np.abs(wav).max() + 1e-9)
    spec = np.abs(np.fft.rfft(wav * np.hanning(len(wav))))
    spec = spec / (spec.sum() + 1e-12)
    entropy = -np.sum(spec * np.log(spec + 1e-12))
    max_entropy = np.log(len(spec))
    concentration = 1.0 - entropy / max_entropy       # 0 noise .. 1 tonal
    active = np.mean(np.abs(wav) > 0.01)
    raw = 0.7 * concentration + 0.3 * active
    return float(1.0 + 4.0 * np.clip(raw, 0, 1))


def try_register_mosnet_native(weights_path=None, device="cuda"):
    """Register MOSNet (``mosnet.py``) under ``"mosnet"`` when converted
    official weights are present: the file-drop path for the Keras
    ``cnn_blstm.h5`` that speechmetrics loads (reference
    ``compute_mos.py:25``; convert with
    ``tools/convert_torch_weights.py mosnet``)."""
    weights_path = weights_path or os.environ.get("METATTS_MOSNET_WEIGHTS")
    if not weights_path or not os.path.exists(weights_path):
        return False
    from .mosnet import MOSNet
    model = MOSNet(weights_path, device=device)

    @register_scorer("mosnet")
    def _mosnet_native(wav, sr):
        return model.score(wav, sr)

    return True


def try_register_mbnet_native(weights_path=None, device="cuda"):
    """Register the MBNet mean net (``mbnet.py``) under ``"mbnet"`` when
    converted official weights are present: the file-drop path for the
    ``Pytorch_MBNet/pre_trained/model-50000.pt`` checkpoint the reference
    loads (``compute_mos.py:148``; convert with
    ``tools/convert_torch_weights.py mbnet``)."""
    weights_path = weights_path or os.environ.get("METATTS_MBNET_WEIGHTS")
    if not weights_path or not os.path.exists(weights_path):
        return False
    from .mbnet import MBNetMean
    model = MBNetMean(weights_path, device=device)

    @register_scorer("mbnet")
    def _mbnet_native(wav, sr):
        return model.score(wav, sr)

    return True


def try_register_wav2vec2_native(weights_path=None, device="cuda"):
    """Register the wav2vec2 scorer (``wav2vec2.py``) under ``"wav2vec2"``
    when converted weights are present: the file-drop path for the
    ``facebook/wav2vec2-base`` checkpoint the reference's SSL scorer family
    builds on (``compute_mos.py:205,320``; convert with
    ``tools/convert_torch_weights.py wav2vec2``).  With a converted MOS
    regression head the score is calibrated; otherwise the embedding-norm
    proxy applies and stays labelled uncalibrated."""
    weights_path = weights_path or os.environ.get("METATTS_WAV2VEC2_WEIGHTS")
    if not weights_path or not os.path.exists(weights_path):
        return False
    from .wav2vec2 import Wav2Vec2Scorer
    model = Wav2Vec2Scorer(weights_path, device=device)

    @register_scorer("wav2vec2")
    def _w2v2_native(wav, sr):
        return model.score(wav, sr)

    return True
