"""Cross-lingual episode extras (reference ``LanguageTaskCollate``,
``lightning/collate.py:199-300``).

For ``adapt.type == "lang"`` episodes the support set provides per-phoneme
representations: the datamodule averages each phoneme's representation
over its occurrences in the support utterances into a (vocab, d_feat)
matrix, from which the codebook ``PhonemeEmbedding`` makes a fresh
``src_word_emb`` table before the inner loop (``meta.py:24-33``).

Datasets provide per-utterance representations as
``representation/<spk>-representation-<base>.npy``, (L, d_feat), aligned
with the phone sequence: the reference precomputes SSL features offline;
the port's preprocessor writes phoneme-averaged log-mels
(``preprocessing.representation.enabled``).
"""

import os
from collections import defaultdict

import numpy as np

from ..text.symbols import symbols


def load_representation(preprocessed_path, speaker, basename):
    p = os.path.join(preprocessed_path, "representation",
                     f"{speaker}-representation-{basename}.npy")
    return np.load(p) if os.path.exists(p) else None


def episode_phoneme_representation(samples, d_feat=None):
    """The mean representation per phoneme id over the episode's support
    samples -> (vocab, d_feat) fp32, zero rows for absent phonemes and for
    the PAD row 0; ``d_feat`` defaults to the first sample's."""
    vocab = len(symbols) + 1
    if d_feat is None:
        for s in samples:
            if s.get("representation") is not None:
                d_feat = s["representation"].shape[-1]
                break
        if d_feat is None:
            raise ValueError(
                "adapt.type=lang needs per-phoneme representations, but no "
                "episode sample carries one. Re-run preprocessing with "
                "`preprocessing: {representation: {enabled: true}}` or drop "
                "SSL features into <preprocessed_path>/representation/ as "
                "<spk>-representation-<base>.npy (L, d_feat).")
    acc = np.zeros((vocab, d_feat), np.float64)
    cnt = np.zeros((vocab,), np.int64)
    for s in samples:
        rep = s.get("representation")
        if rep is None:
            continue
        ids = s["text"][: rep.shape[0]]
        for i, pid in enumerate(ids):
            acc[pid] += rep[i]
            cnt[pid] += 1
    out = np.zeros((vocab, d_feat), np.float32)
    nz = cnt > 0
    out[nz] = (acc[nz] / cnt[nz, None]).astype(np.float32)
    out[0] = 0.0
    return out


def assign_support_query(samples, shots, queries):
    """The episode's K + Q utterances split so that every phoneme of a
    query utterance also occurs in a support utterance (reference
    ``LanguageTaskCollate.split_sup_qry``, ``lightning/collate.py:252-277``):
    the table comes from the support set's representations only, so a query
    phoneme the support lacks would get a zero row.  Walking the utterances
    in order, one goes to the query set only if none of its phonemes is
    unique to it within the remaining pool.

    Returns (sup_idx, qry_idx) index lists into ``samples``; raises
    ValueError when the pool cannot give (shots, queries) so."""
    phn2idxs = defaultdict(list)
    for idx, s in enumerate(samples):
        for phn in set(int(p) for p in s["text"]):
            phn2idxs[phn].append(idx)

    sup_ids, qry_ids = [], []
    for idx, s in enumerate(samples):
        phn_set = set(int(p) for p in s["text"])
        if len(qry_ids) < queries:
            if any(len(phn2idxs[phn]) == 1 for phn in phn_set):
                sup_ids.append(idx)
            else:
                qry_ids.append(idx)
                for phn in phn_set:
                    phn2idxs[phn].remove(idx)
        else:
            sup_ids.append(idx)
    if len(sup_ids) != shots or len(qry_ids) != queries:
        raise ValueError(
            f"coverage split infeasible: got {len(sup_ids)} support / "
            f"{len(qry_ids)} query for shots={shots} queries={queries} "
            "(too many utterances carry unique phonemes); resample the "
            "episode")
    return sup_ids, qry_ids


def split_disjoint_phonemes(sup_samples, qry_samples, rng=None):
    """Keep-masks that make the support's and the query's phoneme
    inventories disjoint: each shared phoneme goes to one side at random
    (``rng``, default ``RandomState(0)``) and is masked out of the other.
    An ablation helper for phoneme-overlap leakage, not the episode rule
    (that is ``assign_support_query``)."""
    rng = rng or np.random.RandomState(0)
    sup_phones = set()
    for s in sup_samples:
        sup_phones.update(int(p) for p in s["text"])
    qry_phones = set()
    for s in qry_samples:
        qry_phones.update(int(p) for p in s["text"])
    shared = sorted(sup_phones & qry_phones)
    to_sup = set()
    for p in shared:
        if rng.rand() < 0.5:
            to_sup.add(p)
    sup_keep = sup_phones - (set(shared) - to_sup)
    qry_keep = qry_phones - to_sup
    sup_masks = [np.isin(s["text"], sorted(sup_keep)) for s in sup_samples]
    qry_masks = [np.isin(s["text"], sorted(qry_keep)) for s in qry_samples]
    return sup_masks, qry_masks
