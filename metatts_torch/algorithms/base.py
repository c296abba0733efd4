"""System base: owns the model, its optimizer, the step counter and the
chain of seeds the training steps draw their dropout from.

The training part of the JAX package's ``System`` (``algorithms/base.py``);
the test stage comes with a later slice.
"""

import torch

from ..models import nn as L
from ..models.fastspeech2 import FastSpeech2
from ..train.optim import NoamAdam
from ..utils.tools import resolve_device
from .adapt import Adaptor

DEFAULT_STATS = {"pitch": [-3.0, 10.0, 0.0, 1.0],
                 "energy": [-2.0, 10.0, 0.0, 1.0]}


class System:
    def __init__(self, preprocess_cfg, model_cfg, train_cfg, algorithm_cfg,
                 stats=None, n_speakers=8, seed=43, device="cuda"):
        """Random init from ``seed`` on ``device`` (default the card; without
        one it raises unless ``device="cpu"``)."""
        if isinstance(preprocess_cfg, list):
            preprocess_cfg = preprocess_cfg[0]
        self.device = resolve_device(device)
        self.pcfg = preprocess_cfg
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        self.acfg = algorithm_cfg
        self.stats = stats or DEFAULT_STATS
        init_seed, train_seed = L.split(seed, 2)
        self.model = FastSpeech2(
            preprocess_cfg, model_cfg, algorithm_cfg, self.stats, n_speakers,
            generator=torch.Generator().manual_seed(init_seed)).to(self.device)
        self.adaptor = Adaptor(self.model, preprocess_cfg, model_cfg,
                               algorithm_cfg)
        self.optimizer = NoamAdam(self.params, model_cfg, train_cfg)
        self.global_step = 0
        self._rng = torch.Generator().manual_seed(train_seed)

    @property
    def params(self):
        """name -> Parameter of the model (the optimizer's leaves)."""
        return dict(self.model.named_parameters())

    def next_rng(self):
        """The next seed of the training chain."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._rng))

    def apply_updates(self, grads):
        """One optimizer step from ``grads`` (name -> tensor)."""
        self.optimizer.step(self.params, grads)
        self.global_step += 1

    def _supervised_loss(self, params, batch, seed, train):
        out = self.adaptor.forward(params, batch, train=train, seed=seed)
        losses = self.adaptor.loss(batch, out)
        return losses.total, losses
