"""Datamodule: the datasets and frozen episode samplers of the val and test
stages (the JAX package's ``data/datamodule.py``; the training loaders wait
for ROADMAP Queue 1 item 6).
"""

import numpy as np

from .dataset import TTSDataset
from .episodes import EpisodeSampler


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


class EpisodeDataModule:
    """The train, val and test splits of every preprocess config, with the
    val and test stages' frozen episodes (reference
    ``baseline_datamodule.py`` / ``meta_datamodule.py``)."""

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
