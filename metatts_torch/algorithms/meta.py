"""MAML system: second-order meta-learning over speaker episodes.

Reference ``lightning/systems/meta.py`` + ``base_adaptor.py``: a training
step adapts on each episode's support set (5 SGD steps, second order) and
back-propagates the query loss through the inner loop; the gradient is the
mean over the episodes, and Adam with the Noam schedule applies it.
"""

import torch

from ..models import nn as L
from ..models.loss import LossValues
from .base import System, episode
from .flags import repeatable


class MetaSystem(System):
    algorithm_type = "meta"

    def _episode_loss(self, params, sup, qry, seed, train, phn_ref=None):
        task = self.acfg["adapt"]["train"]
        losses, _ = self.adaptor.meta_learn(
            params, sup, qry, steps=task["steps"], lr=task["lr"], train=train,
            seed=seed, phn_ref=phn_ref)
        return losses

    @repeatable
    def _meta_train_step(self, sup, qry, seed, phn_ref=None):
        """sup / qry: Batches stacked on a leading episode axis E; phn_ref
        (E, vocab, d_feat) regenerates the phoneme table per episode for
        cross-lingual adaptation (reference ``meta.py:24-33``).  Returns
        (the episodes' mean LossValues, the gradient of the mean total loss
        as name -> tensor); episode e draws from ``split(seed, E)[e]``.
        Each episode is differentiated on its own and the gradients summed,
        so only one episode's graph is alive at a time; under
        ``enable_distributed`` a rank sums its shard's and the sums are
        summed over the ranks."""
        params = self.params
        names = list(params)
        n_episodes = sup.texts.shape[0]
        seeds = L.split(seed, n_episodes)
        self.model.train()
        grads, losses = None, []
        for e in self._episodes(n_episodes):
            lv = self._episode_loss(params, episode(sup, e), episode(qry, e), seeds[e], True,
                                    None if phn_ref is None else phn_ref[e])
            g = torch.autograd.grad(lv.total / n_episodes,
                                    [params[n] for n in names], allow_unused=True)
            grads = g if grads is None else [
                b if a is None else a if b is None else a + b
                for a, b in zip(grads, g)]
            losses.append(LossValues(*(v.detach() for v in lv)))
        if self.shard is not None:
            self.shard.all_reduce_(grads)
        return self._mean_losses(losses, n_episodes), dict(zip(names, grads))

    def train_step(self, sup_batch, qry_batch, phn_ref=None):
        """One meta step over episode-stacked support / query Batches (and,
        for cross-lingual episodes, their (E, vocab, d_feat) ``phn_ref``).
        Returns the episodes' mean LossValues."""
        losses, grads = self._meta_train_step(
            sup_batch.to(self.device), qry_batch.to(self.device), self.next_rng(),
            None if phn_ref is None else phn_ref.to(self.device))
        self.apply_updates(grads)
        return losses
