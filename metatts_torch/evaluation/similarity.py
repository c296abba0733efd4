"""Speaker-similarity metrics over d-vectors (numpy).

Reference: ``evaluation/centroid_similarity.py:21`` (cosine to enrollment
centroid) and ``evaluation/pair_similarity.py:16`` (same/different-speaker
pair cosine similarities).  The port keeps its own copy of the TPU
package's numpy functions; on the same inputs both return the same values.
"""

import numpy as np


def _unit(x, axis=-1):
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), 1e-8)


def centroid_similarity(enroll_dvecs, test_dvecs):
    """Cosine similarity of each test d-vector to the enrollment centroid.

    enroll_dvecs: (N, D); test_dvecs: (M, D) -> (M,) similarities.
    """
    centroid = _unit(np.mean(np.asarray(enroll_dvecs), axis=0))
    return _unit(np.asarray(test_dvecs)) @ centroid


def pair_similarity(dvecs_by_speaker, rng=None, n_pairs=None):
    """Same-speaker and different-speaker pair cosine similarities.

    dvecs_by_speaker: dict speaker -> (N_i, D) arrays.
    Returns (same_scores, diff_scores); with ``n_pairs`` each is subsampled
    without replacement by ``rng`` (default ``RandomState(0)``).
    """
    rng = rng or np.random.RandomState(0)
    speakers = sorted(dvecs_by_speaker)
    same, diff = [], []
    for s in speakers:
        v = _unit(np.asarray(dvecs_by_speaker[s]))
        n = len(v)
        for i in range(n):
            for j in range(i + 1, n):
                same.append(float(v[i] @ v[j]))
    for a_i in range(len(speakers)):
        for b_i in range(a_i + 1, len(speakers)):
            va = _unit(np.asarray(dvecs_by_speaker[speakers[a_i]]))
            vb = _unit(np.asarray(dvecs_by_speaker[speakers[b_i]]))
            for x in va:
                for y in vb:
                    diff.append(float(x @ y))
    same, diff = np.asarray(same), np.asarray(diff)
    if n_pairs is not None:
        if len(same) > n_pairs:
            same = same[rng.choice(len(same), n_pairs, replace=False)]
        if len(diff) > n_pairs:
            diff = diff[rng.choice(len(diff), n_pairs, replace=False)]
    return same, diff
