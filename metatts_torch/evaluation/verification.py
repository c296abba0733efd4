"""Speaker verification: EER / DET / AUC from pair scores (numpy).

Reference ``evaluation/speaker_verification.py:20`` uses sklearn's
det_curve + roc metrics; the same arithmetic here, without sklearn.
"""

import warnings

import numpy as np


def speaker_verification_eer(same_scores, diff_scores):
    """Returns dict with eer, threshold, auc, fpr/fnr arrays.

    Degenerate inputs (no same- or no different-speaker pairs, e.g. one
    wav a speaker) return NaN metrics with a warning instead of raising;
    callers can filter on finiteness.
    """
    if len(same_scores) == 0 or len(diff_scores) == 0:
        warnings.warn(
            f"speaker_verification_eer: need both same ({len(same_scores)})"
            f" and different ({len(diff_scores)}) speaker pairs; returning"
            " NaN metrics", stacklevel=2)
        return {"eer": float("nan"), "threshold": float("nan"),
                "auc": float("nan"), "fpr": np.zeros(0), "fnr": np.zeros(0)}
    scores = np.concatenate([same_scores, diff_scores])
    labels = np.concatenate([np.ones(len(same_scores)),
                             np.zeros(len(diff_scores))])
    order = np.argsort(-scores)
    scores_sorted = scores[order]
    labels_sorted = labels[order]

    tp = np.cumsum(labels_sorted)
    fp = np.cumsum(1 - labels_sorted)
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    tpr = tp / max(n_pos, 1)
    fpr = fp / max(n_neg, 1)
    fnr = 1 - tpr

    i = int(np.argmin(np.abs(fpr - fnr)))
    eer = float((fpr[i] + fnr[i]) / 2)
    auc = float(np.trapezoid(tpr, fpr))
    return {
        "eer": eer,
        "threshold": float(scores_sorted[i]),
        "auc": auc,
        "fpr": fpr,
        "fnr": fnr,
    }
