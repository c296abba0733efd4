"""Baseline system: plain multi-speaker training, meta-style validation.

Reference ``lightning/systems/baseline.py:15-53`` and the JAX package's
``algorithms/baseline.py``: a training step is a supervised forward and
loss over a flat batch; validation still adapts first-order like MAML
(``System.validation_step``), so baseline and meta models compare at eval.
"""

import torch

from ..models.loss import LossValues
from .base import System


class BaselineSystem(System):
    algorithm_type = "baseline"

    def train_step(self, batch):
        """One supervised step over a flat Batch: the training forward with
        dropout (seeded from ``next_rng()``), which updates the postnet's
        BatchNorm running statistics as the JAX step keeps its new state;
        the loss; the gradient of every parameter, the encoder's included;
        one optimizer step.  Returns LossValues."""
        batch = batch.to(self.device)
        self.model.train()
        params = self.params
        total, losses = self._supervised_loss(params, batch, self.next_rng(), True,
                                              update_bn_state=True)
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        self.apply_updates(dict(zip(params, grads)))
        return LossValues(*(v.detach() for v in losses))
