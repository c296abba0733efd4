"""Optimizer: Adam with Noam warm-up and step anneal.

Reference ``lightning/optimizer.py:7-16`` (Adam, lr scaled by
d_model^-0.5, betas (0.9, 0.98), eps 1e-9) and ``lightning/scheduler.py``
(warm-up, then inverse square root, times anneal_rate at each anneal step),
in the JAX package's order of transformations (an optax chain): clip by
global norm, then Adam, then decoupled weight decay, then the learning
rate; with ``grad_acc_step`` > 1 the gradients of that many calls are
averaged and applied on the last (optax ``MultiSteps``).

``state_tree`` / ``load_state_tree`` carry the state across packages: the
tree ``flax.serialization.to_state_dict`` makes of the JAX package's optax
chain, so a checkpoint of either package resumes in the other.
"""

import numpy as np
import torch

f32 = torch.float32


def noam_schedule(d_model, warmup, anneal_steps, anneal_rate):
    """step -> lr, computed in fp32 with ``lr(max(step, 1))``; an empty
    ``anneal_steps`` never anneals."""
    init_lr = float(np.power(d_model, -0.5))
    anneals = list(anneal_steps or [])

    def lr(step):
        s = torch.tensor(max(int(step), 1), dtype=f32)
        base = torch.tensor(init_lr, dtype=f32) * torch.minimum(
            s ** -0.5, s * torch.tensor(float(warmup) ** -1.5, dtype=f32))
        if not anneals:
            return base
        n = sum(int(step) >= a for a in anneals)
        return base * torch.tensor(anneal_rate, dtype=f32) ** torch.tensor(n, dtype=f32)

    return lr


def linear_warmup_schedule(peak, warmup):
    """step -> lr, optax's ``linear_schedule(0, peak, warmup)`` in fp32: a
    ramp from 0 at step 0 to ``peak`` at step ``warmup``, then constant."""
    def lr(step):
        frac = 1.0 - (torch.tensor(min(max(int(step), 0), warmup), dtype=f32)
                      / torch.tensor(float(warmup), dtype=f32))
        return torch.tensor(-float(peak), dtype=f32) * frac + torch.tensor(float(peak), dtype=f32)

    return lr


class NoamAdam:
    """The training optimizer over a dict of named parameters.

    ``step(params, grads)`` updates ``params`` (name -> tensor) in place from
    ``grads`` (name -> tensor, None for none); while gradients accumulate it
    leaves them as they are.  ``schedule`` (step -> lr) replaces the Noam
    schedule of the configs, e.g. ``linear_warmup_schedule``.
    """

    def __init__(self, params, model_cfg, train_cfg, schedule=None):
        o = train_cfg["optimizer"]
        self.lr = schedule or noam_schedule(
            model_cfg["transformer"]["encoder_hidden"], o["warm_up_step"],
            o["anneal_steps"], o["anneal_rate"])
        self.b1, self.b2 = (float(b) for b in o["betas"])
        self.eps = float(o["eps"])
        self.clip = float(o["grad_clip_thresh"])
        self.weight_decay = float(o.get("weight_decay", 0.0))
        self.acc_steps = int(o.get("grad_acc_step", 1) or 1)
        self.mu = {n: torch.zeros_like(p, dtype=f32) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=f32) for n, p in params.items()}
        self.count = 0          # Adam's and the schedule's step count
        self.mini_step = 0
        self.acc = ({n: torch.zeros_like(p, dtype=f32) for n, p in params.items()}
                    if self.acc_steps > 1 else None)

    @torch.no_grad()
    def step(self, params, grads):
        grads = {n: (torch.zeros_like(self.mu[n]) if grads.get(n) is None
                     else grads[n].float()) for n in self.mu}
        if self.acc is not None:
            for n, g in grads.items():
                self.acc[n].add_((g - self.acc[n]) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.acc_steps:
                return
            grads = {n: a.clone() for n, a in self.acc.items()}
            for a in self.acc.values():
                a.zero_()
            self.mini_step = 0
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = not bool(g_norm < self.clip)
        self.count += 1
        k = torch.tensor(float(self.count), dtype=f32)
        c1 = (1.0 - torch.tensor(self.b1, dtype=f32) ** k).item()
        c2 = (1.0 - torch.tensor(self.b2, dtype=f32) ** k).item()
        lr = -self.lr(self.count - 1).item()
        for n, p in params.items():
            g = grads[n] / g_norm * self.clip if clip else grads[n]
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            u = u + self.weight_decay * p.float()
            p.add_((lr * u).to(p.dtype))

    # ------------------------------------------------- the optax layout

    def _named(self, tree, model):
        from ..convert import named_from_jax_params_tree
        got = named_from_jax_params_tree(model, tree)
        return {n: got[n].to(self.mu[n].device) for n in self.mu}

    @staticmethod
    def _moments(model, named):
        """A moment tree in the layout of the JAX ``params``, its lists as
        maps with string indices, as ``to_state_dict`` writes them."""
        from ..convert import jax_params_tree

        def as_state_dict(t):
            if isinstance(t, list):
                return {str(i): as_state_dict(v) for i, v in enumerate(t)}
            if isinstance(t, dict):
                return {k: as_state_dict(v) for k, v in t.items()}
            return t
        return as_state_dict(jax_params_tree(model, named))

    def state_tree(self, model):
        """The state as ``to_state_dict`` of the JAX optax chain over
        ``model``'s parameters: ``{'0': {}, '1': {'count', 'mu', 'nu'}, '2':
        {}, '3': {'count'}}`` (clip, Adam, weight decay, the schedule), inside
        ``MultiSteps``' ``{'acc_grads', 'gradient_step', 'inner_opt_state',
        'mini_step', 'skip_state'}`` when gradients accumulate; moments fp32,
        counts int32, moment trees in the layout of the JAX ``params``."""
        count = np.asarray(self.count, np.int32)
        chain = {"0": {}, "1": {"count": count,
                                "mu": self._moments(model, self.mu),
                                "nu": self._moments(model, self.nu)},
                 "2": {}, "3": {"count": count}}
        if self.acc is None:
            return chain
        return {"acc_grads": self._moments(model, self.acc),
                "gradient_step": count, "inner_opt_state": chain,
                "mini_step": np.asarray(self.mini_step, np.int32),
                "skip_state": {}}

    @torch.no_grad()
    def load_state_tree(self, tree, model):
        """Load a ``state_tree`` (of either package, as a checkpoint restores
        it: lists as maps with string indices).  Raises ValueError where the
        tree has another layout (gradient accumulation on one side only, a
        missing leaf, another shape) or Adam's and the schedule's counts
        differ."""
        chain = tree
        if self.acc is not None:
            if "inner_opt_state" not in tree:
                raise ValueError("the optimizer state has no gradient accumulation "
                                 f"(grad_acc_step {self.acc_steps} here)")
            chain = tree["inner_opt_state"]
        elif "inner_opt_state" in tree:
            raise ValueError("the optimizer state accumulates gradients "
                             "(grad_acc_step 1 here)")
        counts = {int(np.asarray(chain["1"]["count"])), int(np.asarray(chain["3"]["count"]))}
        if self.acc is not None:
            counts.add(int(np.asarray(tree["gradient_step"])))
        if len(counts) != 1:
            raise ValueError(f"the optimizer state's step counts differ: {sorted(counts)}")
        mu, nu = self._named(chain["1"]["mu"], model), self._named(chain["1"]["nu"], model)
        acc = None if self.acc is None else self._named(tree["acc_grads"], model)
        for n in self.mu:
            self.mu[n].copy_(mu[n])
            self.nu[n].copy_(nu[n])
            if acc is not None:
                self.acc[n].copy_(acc[n])
        self.count = counts.pop()
        if acc is not None:
            self.mini_step = int(np.asarray(tree["mini_step"]))
