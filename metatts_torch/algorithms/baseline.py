"""Baseline system: plain multi-speaker training, meta-style validation.

Reference ``lightning/systems/baseline.py:15-53`` and the JAX package's
``algorithms/baseline.py``: a training step is a supervised forward and
loss over a flat batch; validation still adapts first-order like MAML
(``System.validation_step``), so baseline and meta models compare at eval.
"""

import contextlib

import torch

from ..data.collate import map_batch
from ..models.loss import LossValues
from ..parallel.distributed import row_shard
from ..utils.profiling import span
from .base import System
from .flags import repeatable


class BaselineSystem(System):
    algorithm_type = "baseline"

    @repeatable
    def _train_step(self, batch, seed):
        """The training forward with dropout from ``seed``, which updates
        the postnet's BatchNorm running statistics as the JAX step keeps its
        new state; the loss; the gradient of every parameter, the encoder's
        included.  Returns (LossValues, name -> gradient).

        Under ``enable_distributed`` a rank computes its rows of the batch
        within ``row_shard``, so the losses' valid counts, the BatchNorm
        statistics and the dropout masks are the whole batch's, and the
        gradients and losses are summed over the ranks."""
        self.model.train()
        params = self.params
        ctx = contextlib.nullcontext()
        if self.shard is not None:
            B = batch.texts.shape[0]
            lo, hi = self.shard.bounds(B, "batch_size")
            batch = map_batch(lambda t: t[lo:hi], batch)
            ctx = row_shard(lo, hi, B)
        with ctx:
            with span("metatts.train.forward"):
                total, losses = self._supervised_loss(params, batch, seed, True,
                                                      update_bn_state=True)
            with span("metatts.train.backward"):
                grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        losses = [v.detach() for v in losses]
        if self.shard is not None:
            self.shard.all_reduce_(list(grads) + losses)
        return LossValues(*losses), dict(zip(params, grads))

    def train_step(self, batch):
        """One supervised step over a flat Batch (``_train_step`` with the
        next seed of the chain), then one optimizer step, under the root span
        ``metatts.train.step`` (``utils/profiling.py``; the batch's copy to
        the device, forward, backward and optimizer in spans of their own).
        Returns LossValues."""
        with span("metatts.train.step"):
            with span("metatts.train.to_device"):
                batch = batch.to(self.device)
            losses, grads = self._train_step(batch, self.next_rng())
            self.apply_updates(grads)
            # the step's tensors are freed inside its root span, so the span
            # holds all of the host's work of the step
            del batch, grads
        return losses
