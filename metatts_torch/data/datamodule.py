"""Datamodules: datasets and samplers per algorithm type (the JAX package's
``data/datamodule.py``).

Registry mirrors the reference (``lightning/datamodules/__init__.py:6-14``):
  base      -- plain supervised loaders
  baseline  -- flat shuffled train batches, frozen episodic val/test
  meta      -- episodic train (cross-lingual episodes with their
               per-phoneme representations for ``adapt.type == "lang"``)
               + frozen episodic val/test

The training loaders make numpy's draws in the JAX package's order, so both
packages yield the same utterances batch for batch from the same seed.
"""

import numpy as np
import torch

from .collate import collate_batch, collate_episode
from .dataset import TTSDataset
from .episodes import EpisodeSampler
from .lang_episodes import assign_support_query, episode_phoneme_representation


class ConcatDataset:
    """Multi-corpus concatenation (the reference trains over a list of
    preprocess configs)."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def _locate(self, idx):
        d = int(np.searchsorted(self.offsets[1:], idx, side="right"))
        return self.datasets[d], idx - int(self.offsets[d])

    def __getitem__(self, idx):
        ds, i = self._locate(idx)
        return ds[i]

    def speaker_label(self, idx):
        ds, i = self._locate(idx)
        return ds.speaker_label(i)


class BaseDataModule:
    def __init__(self, preprocess_configs, train_config, algorithm_config,
                 log_dir=".", spk_refer_wav=False, seed=43):
        self.pcfgs = preprocess_configs
        self.tcfg = train_config
        self.acfg = algorithm_config
        self.log_dir = log_dir
        self.spk_refer_wav = spk_refer_wav
        self.seed = seed
        self.max_seq_len = 1000

    def _load_split(self, split):
        sets = []
        for pcfg in self.pcfgs:
            subset = pcfg["subsets"].get(split)
            if subset is None:
                continue
            names = subset if isinstance(subset, list) else [subset]
            for n in names:
                sets.append(TTSDataset(f"{n}.txt", pcfg,
                                       spk_refer_wav=self.spk_refer_wav))
        if not sets:
            raise ValueError(f"no datasets for split {split}")
        return ConcatDataset(sets) if len(sets) > 1 else sets[0]

    def setup(self):
        self.train_set = self._load_split("train")
        self.val_set = self._load_split("val")
        self.test_set = self._load_split("test")

    def train_batches(self, batch_size, rng=None):
        """Endless (Batch, CollateMeta) pairs of ``batch_size`` training
        utterances: a fresh permutation per epoch, or draws with replacement
        where the corpus is smaller than a batch (the JAX package's branch
        for tiny corpora)."""
        rng = rng or np.random.RandomState(self.seed)
        n = len(self.train_set)
        if n < batch_size:
            print(f"[data] dataset has {n} < batch_size={batch_size} "
                  f"utterances; sampling with replacement")
            while True:
                idx = rng.randint(0, n, size=batch_size)
                yield collate_batch([self.train_set[int(j)] for j in idx],
                                    self.max_seq_len)
        while True:
            order = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                samples = [self.train_set[j] for j in order[i:i + batch_size]]
                yield collate_batch(samples, self.max_seq_len)


class BaselineDataModule(BaseDataModule):
    """Flat train loader + frozen episodic val/test
    (reference ``baseline_datamodule.py``)."""

    def setup(self):
        super().setup()
        task = self.acfg["adapt"]["train"]
        test_task = self.acfg["adapt"]["test"]
        self.val_sampler = EpisodeSampler(
            self.val_set, task["shots"], task["queries"], seed=self.seed)
        self.test_sampler = EpisodeSampler(
            self.test_set, test_task["shots"], test_task["queries"],
            seed=self.seed)

    def val_episodes(self, n_tasks_per_label=4):
        descs = self.val_sampler.tasks_or_prefetch(
            n_tasks_per_label, self.log_dir, "val")
        for d in descs:
            yield d, self.val_sampler.episode_from_description(d)

    def test_episodes(self, n_tasks_per_label=16):
        descs = self.test_sampler.tasks_or_prefetch(
            n_tasks_per_label, self.log_dir, "test")
        for d in descs:
            yield d, self.test_sampler.episode_from_description(d)


class MetaDataModule(BaselineDataModule):
    """Episodic training (reference ``meta_datamodule.py``)."""

    def setup(self):
        super().setup()
        task = self.acfg["adapt"]["train"]
        self.train_sampler = EpisodeSampler(
            self.train_set, task["shots"], task["queries"], seed=self.seed)

    def train_episode_batches(self, meta_batch_size):
        """Endless ``collate_episode`` tuples (sup, qry, sup metas, qry
        metas) of ``meta_batch_size`` episodes each.  Cross-lingual episodes
        (``adapt.type == "lang"``) are first re-split so that the support
        covers every query phoneme, and the tuple gains a fifth item: the
        support's per-phoneme representations, (E, vocab, d_feat) on the
        CPU."""
        lang = self.acfg["adapt"]["type"] == "lang"
        while True:
            sup, qry = self.train_sampler.sample_meta_batch(meta_batch_size)
            if lang:
                sup, qry = self._lang_coverage_resplit(sup, qry)
            batch = collate_episode(sup, qry, self.max_seq_len)
            if not lang:
                yield batch
                continue
            phn_ref = np.stack([episode_phoneme_representation(ep) for ep in sup])
            want = self.acfg["adapt"]["phoneme_emb"].get("representation_dim")
            if want is not None and phn_ref.shape[-1] != want:
                raise ValueError(
                    f"adapt.phoneme_emb.representation_dim={want} but the "
                    f"corpus representations are {phn_ref.shape[-1]}-dim; "
                    "set representation_dim to match (the built-in "
                    "featurizer emits n_mel_channels dims)")
            yield batch + (torch.from_numpy(phn_ref),)

    def _lang_coverage_resplit(self, sup, qry):
        """Each episode's utterances re-split so that the support covers
        every query phoneme (``assign_support_query``; reference
        ``collate.py:252-277``), since the episode's phoneme table comes
        from the support's representations only.  An episode where that is
        infeasible keeps the sampler's split."""
        new_sup, new_qry = [], []
        for s_ep, q_ep in zip(sup, qry):
            pool = list(s_ep) + list(q_ep)
            try:
                s_idx, q_idx = assign_support_query(
                    pool, shots=len(s_ep), queries=len(q_ep))
            except ValueError:
                s_idx, q_idx = range(len(s_ep)), range(len(s_ep), len(pool))
            new_sup.append([pool[i] for i in s_idx])
            new_qry.append([pool[i] for i in q_idx])
        return new_sup, new_qry


DATAMODULES = {
    "base": BaseDataModule,
    "baseline": BaselineDataModule,
    "meta": MetaDataModule,
    "imaml": MetaDataModule,
}


def get_datamodule(algorithm_type):
    return DATAMODULES[algorithm_type]
