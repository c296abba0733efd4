"""iMAML system: implicit meta-gradients by conjugate gradient (the JAX
package's ``algorithms/imaml.py``; reference ``lightning/systems/imaml.py``
with the hypergrad CG of ``lightning/systems/utils.py:120-189``):

  inner:  w* ~= argmin_w  L_sup(w) + (reg/2)||w - theta0||^2   (K SGD steps)
  fp map: Phi(w, theta0, frozen) = w - lr * grad_w [L_sup(w) + reg-term]
  solve:  (I - dPhi/dw)^T x = grad_w L_qry(w*)      (CG, a fixed count)
  hyper:  dL/dtheta0 = (dPhi/dtheta0)^T x = lr * reg * x
          dL/dfrozen = direct grad + (dPhi/dfrozen)^T x
                     = direct grad - lr * H_{frozen,w} x

The CG matvec is a Hessian-vector product through the support gradient's
graph, built once an episode on einsum attention (it is differentiated
twice); the query loss and its gradient run on the model's attention, the
flash kernels on the card.  Episodes run one after another, so only one
episode's graph is alive at a time.
"""

import torch

from ..data.collate import split_batch
from ..models import nn as L
from ..models.loss import LossValues
from .adapt import episode_speaker_args, merge, partition
from .base import System, episode
from .flags import repeatable


def _dot(a, b):
    return sum((x * y).sum() for x, y in zip(a, b))


def tree_cg(matvec, b, iters):
    """Conjugate gradient over lists of tensors, ``iters`` iterations.  A
    direction of non-positive curvature (the inner Hessian at a random
    init is indefinite) freezes the iterate instead of stepping along it."""
    x = [torch.zeros_like(t) for t in b]
    r, p = list(b), list(b)
    rs = _dot(r, r)
    for _ in range(iters):
        ap = matvec(p)
        pap = _dot(p, ap)
        alpha = torch.where(pap > 1e-20, rs / torch.clamp(pap, min=1e-20),
                            torch.zeros_like(pap))
        x = [xi + alpha * pi for xi, pi in zip(x, p)]
        r = [ri - alpha * api for ri, api in zip(r, ap)]
        rs_new = _dot(r, r)
        beta = rs_new / torch.clamp(rs, min=1e-20)
        p = [ri + beta * pi for ri, pi in zip(r, p)]
        rs = rs_new
    return x


def _leaves(tensors, grad=True):
    return [t.detach().requires_grad_(grad) for t in tensors]


def _zeros_for_none(grads, like):
    return [torch.zeros_like(t) if g is None else g for g, t in zip(grads, like)]


class IMAMLSystem(System):
    algorithm_type = "imaml"

    def _inner_loss(self, adapted, frozen, theta0, sup, seed):
        """The support loss on einsum attention plus the proximal term
        ``0.5 * reg * ||adapted - theta0||^2`` (name -> tensor dicts)."""
        reg = self.acfg["adapt"]["imaml"]["reg_param"]
        out = self.adaptor.forward(merge(adapted, frozen), sup, train=True, seed=seed,
                                   attention_impl="einsum")
        task_loss = self.adaptor.loss(sup, out).total
        d = [adapted[k] - theta0[k] for k in adapted]
        return task_loss + 0.5 * reg * _dot(d, d)

    def _fp_map(self, adapted, theta0, frozen, sup, seed, lr):
        """One regularised SGD step (the fixed-point map Phi) on detached
        copies; returns detached tensors."""
        names = list(adapted)
        with torch.enable_grad():
            w = _leaves(adapted.values())
            loss = self._inner_loss(dict(zip(names, w)), frozen, theta0, sup, seed)
            g = torch.autograd.grad(loss, w)
        return {n: (wi - lr * gi).detach() for n, wi, gi in zip(names, w, g)}

    def _support_minibatch(self, sup, seed):
        """``adapt.imaml.batch_size`` support utterances drawn without
        replacement for one inner step (the reference's Task minibatcher,
        ``imaml.py:51-73``), from a generator seeded with ``seed``; unset or
        at least the support size keeps the whole set."""
        bs = self.acfg["adapt"]["imaml"].get("batch_size")
        K = sup.texts.shape[0]
        if not bs or bs >= K:
            return sup
        idx = torch.randperm(K, generator=torch.Generator().manual_seed(seed))[:bs]
        return split_batch(sup, idx)

    def _episode_hypergrad(self, params, sup, qry, seed):
        """One episode's implicit meta-gradient: (name -> tensor over every
        parameter, the query's LossValues)."""
        task = self.acfg["adapt"]["train"]
        cg_iters = self.acfg["adapt"]["imaml"]["cg_steps"]
        reg = self.acfg["adapt"]["imaml"]["reg_param"]
        lr, steps = task["lr"], task["steps"]
        theta0, frozen = partition({k: v.detach() for k, v in params.items()},
                                   self.adaptor.modules)
        names_w, names_f = list(theta0), list(frozen)
        r_inner, r_mb, r_fp, r_qry = L.split(seed, 4)

        # the first-order inner loop, each step on a fresh support draw
        w = theta0
        for i in range(steps):
            sup_i = self._support_minibatch(sup, L.fold_in(r_mb, i))
            w = self._fp_map(w, theta0, frozen, sup_i, L.fold_in(r_inner, i), lr)
        # the CG's linearisation point takes one more draw (index ``steps``)
        sup_fp = self._support_minibatch(sup, L.fold_in(r_mb, steps))

        with torch.enable_grad():
            # the query loss at w* and its gradient in w* and the frozen
            # modules, on the model's attention (flash on the card)
            w_l, f_l = _leaves(w.values()), _leaves(frozen.values())
            qry_c = qry._replace(speaker_args=episode_speaker_args(
                sup.speaker_args, qry.speaker_args))
            out = self.adaptor.forward(merge(dict(zip(names_w, w_l)),
                                             dict(zip(names_f, f_l))),
                                       qry_c, train=True, seed=r_qry, average_spk_emb=True)
            losses = self.adaptor.loss(qry_c, out)
            g = torch.autograd.grad(losses.total, w_l + f_l, allow_unused=True)
            g_w = _zeros_for_none(g[:len(w_l)], w_l)
            g_frozen = g[len(w_l):]

            # CG on (I - dPhi/dw)^T x = g_w, the matvec x - vjp_w(x) with
            # vjp_w(x) = x - lr * (H + reg I) x through the support
            # gradient's graph at w*, built once
            w_l, f_l = _leaves(w.values()), _leaves(frozen.values())
            g_in = torch.autograd.grad(
                self._inner_loss(dict(zip(names_w, w_l)), dict(zip(names_f, f_l)),
                                 theta0, sup_fp, r_fp),
                w_l, create_graph=True)

            def matvec(x):
                hx = _zeros_for_none(torch.autograd.grad(
                    g_in, w_l, grad_outputs=x, retain_graph=True, allow_unused=True), x)
                vjp = [xi - lr * hi for xi, hi in zip(x, hx)]
                return [xi - vi for xi, vi in zip(x, vjp)]

            x = tree_cg(matvec, g_w, cg_iters)
            # (dPhi/dfrozen)^T x = -lr * H_{frozen,w} x
            h_f = torch.autograd.grad(g_in, f_l, grad_outputs=x, allow_unused=True)
        hyper = {n: lr * reg * xi for n, xi in zip(names_w, x)}
        for n, gd, hf in zip(names_f, g_frozen, h_f):
            hyper[n] = ((torch.zeros_like(frozen[n]) if gd is None else gd)
                        + (0.0 if hf is None else -lr * hf))
        return hyper, LossValues(*(v.detach() for v in losses))

    @repeatable
    def _train_step(self, sup, qry, seed):
        """sup / qry: Batches stacked on a leading episode axis E.  Returns
        (the episodes' mean LossValues, the mean hypergradient with its
        non-finite entries zeroed, then clipped to the global norm
        ``grad_clip_thresh``); episode e draws from ``split(seed, E)[e]``.
        Under ``enable_distributed`` a rank computes its shard's episodes."""
        params = self.params
        E = sup.texts.shape[0]
        seeds = L.split(seed, E)
        self.model.train()
        grads, losses = None, []
        for e in self._episodes(E):
            g, lv = self._episode_hypergrad(params, episode(sup, e), episode(qry, e), seeds[e])
            grads = g if grads is None else {n: grads[n] + g[n] for n in grads}
            losses.append(lv)
        if self.shard is not None:
            # the sum over every rank's episodes, before the NaN-zeroing and
            # the clip, which then do the same on every rank
            self.shard.all_reduce_(list(grads.values()))
        # CG on an indefinite inner Hessian can blow up: zero non-finite
        # entries, then clip by global norm (reference imaml.py:125-131),
        # before the optimizer's own clip
        grads = {n: torch.nan_to_num(v / E, nan=0.0, posinf=0.0, neginf=0.0)
                 for n, v in grads.items()}
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = self.tcfg["optimizer"]["grad_clip_thresh"]
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = {n: g * scale for n, g in grads.items()}
        return self._mean_losses(losses, E), grads

    def train_step(self, sup_batch, qry_batch):
        """One iMAML outer step over episode-stacked support / query Batches.
        Returns the episodes' mean LossValues.  Validation is the plain
        first-order ``System.validation_step``, as in the reference."""
        losses, grads = self._train_step(sup_batch.to(self.device),
                                         qry_batch.to(self.device), self.next_rng())
        self.apply_updates(grads)
        return losses
