"""Episode sampling + frozen episode persistence.

Replaces learn2learn's MetaDataset/TaskDataset machinery
(``lightning/datamodules/utils.py:14-65``): 1-way-(K+Q)-shot tasks grouped by
speaker label.  Val/test episodes are sampled once under a fixed seed and
persisted to ``{split}_descriptions.json`` / ``{split}_SQids.json`` so that
evaluation replays identical tasks across runs and checkpoints (reference
``datamodules/utils.py:68-130``).  The draws are numpy's ``RandomState``
ones of the JAX package's sampler, so both packages pick the same tasks
from the same corpus and seed, and write the same files.
"""

import json
import os
from collections import defaultdict

import numpy as np


class EpisodeSampler:
    def __init__(self, dataset, shots, queries, seed=43, min_per_label=None):
        self.dataset = dataset
        self.shots = shots
        self.queries = queries
        need = min_per_label or (shots + queries)
        by_label = defaultdict(list)
        for i in range(len(dataset)):
            by_label[dataset.speaker_label(i)].append(i)
        self.by_label = {k: v for k, v in by_label.items() if len(v) >= need}
        self.labels = sorted(self.by_label)
        if not self.labels:
            raise ValueError("no speaker has enough utterances for episodes")
        self.rng = np.random.RandomState(seed)

    def sample_indices(self, label=None):
        label = label or self.labels[self.rng.randint(len(self.labels))]
        pool = self.by_label[label]
        pick = self.rng.choice(len(pool), self.shots + self.queries,
                               replace=False)
        idx = [pool[p] for p in pick]
        return idx[: self.shots], idx[self.shots:]

    def sample_episode(self):
        sup_idx, qry_idx = self.sample_indices()
        return ([self.dataset[i] for i in sup_idx],
                [self.dataset[i] for i in qry_idx])

    def sample_meta_batch(self, n_episodes):
        eps = [self.sample_episode() for _ in range(n_episodes)]
        return [s for s, _ in eps], [q for _, q in eps]

    # --------------------------------------------------- frozen episodes

    def prefetch_tasks(self, n_tasks_per_label, out_dir, tag):
        """Sample and persist episode descriptions (reference
        ``prefetch_tasks`` under seed_all(43))."""
        descs = []
        for label in self.labels:
            for _ in range(n_tasks_per_label):
                sup_idx, qry_idx = self.sample_indices(label)
                descs.append({"label": label, "sup": sup_idx,
                              "qry": qry_idx})
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{tag}_descriptions.json"),
                  "w") as f:
            json.dump(descs, f)
        sqids = {}
        for t, d in enumerate(descs):
            sup_ids = [self.dataset[i]["id"] for i in d["sup"]]
            qry_ids = [self.dataset[i]["id"] for i in d["qry"]]
            key = ",".join(sup_ids) + "." + ",".join(qry_ids)
            sqids[key] = f"{tag}_{t:03d}"
        with open(os.path.join(out_dir, f"{tag}_SQids.json"), "w") as f:
            json.dump(sqids, f)
        return descs

    @staticmethod
    def load_tasks(out_dir, tag):
        path = os.path.join(out_dir, f"{tag}_descriptions.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def tasks_or_prefetch(self, n_tasks_per_label, out_dir, tag):
        descs = self.load_tasks(out_dir, tag)
        if descs is None:
            descs = self.prefetch_tasks(n_tasks_per_label, out_dir, tag)
        return descs

    def episode_from_description(self, desc):
        return ([self.dataset[i] for i in desc["sup"]],
                [self.dataset[i] for i in desc["qry"]])
