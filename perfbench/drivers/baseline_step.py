"""The baseline's training step: ``BaselineSystem.train_step`` on a batch
collated by the system's ``collate_batch`` (padded to its longest
utterance's bucket)."""

from .. import roofline
from . import common as C
from .training import TrainCell
from ..reference import train as RT


class Cell(TrainCell):
    def make_system(self):
        from metatts_torch.algorithms.baseline import BaselineSystem
        cfg = self.cfg
        return BaselineSystem(cfg["preprocess"], cfg["model"], cfg["train"], cfg["algorithm"],
                              cfg["stats"], cfg["n_speakers"], seed=self.seed % 2 ** 63,
                              device=self.device)

    def collate(self, unit):
        from metatts_torch.data.collate import collate_batch
        return (collate_batch(unit, self.cfg["model"]["max_seq_len"])[0],)

    def lengths(self, unit):
        return [len(s["text"]) for s in unit], [len(s["mel"]) for s in unit]

    def ideal_s(self, records):
        return sum(roofline.baseline_ideal_s(*self.lengths(self.pool[r["unit"]]),
                                             self.cfg["model"]) for r in records)

    def end_to_end(self):
        return {"train_frames_per_s": sum(r["frames"] for r in self.records) / self.window_s}

    def reference_step(self, P, unit, seed, q):
        b = C.pad(unit, self.device, cap=self.cfg["model"]["max_seq_len"])
        return RT.baseline_step(P, self.cfg, self.cfg["stats"], b, seed, q)
