"""Optimizer: Adam with Noam warm-up and step anneal.

Reference ``lightning/optimizer.py:7-16`` (Adam, lr scaled by
d_model^-0.5, betas (0.9, 0.98), eps 1e-9) and ``lightning/scheduler.py``
(warm-up, then inverse square root, times anneal_rate at each anneal step),
in the JAX package's order of transformations (an optax chain): clip by
global norm, then Adam, then decoupled weight decay, then the learning
rate; with ``grad_acc_step`` > 1 the gradients of that many calls are
averaged and applied on the last (optax ``MultiSteps``).
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


class NoamAdam:
    """The training optimizer over a dict of named parameters.

    ``step(params, grads)`` updates ``params`` (name -> tensor) in place from
    ``grads`` (name -> tensor, None for none); while gradients accumulate it
    leaves them as they are.
    """

    def __init__(self, params, model_cfg, train_cfg):
        o = train_cfg["optimizer"]
        self.lr = noam_schedule(model_cfg["transformer"]["encoder_hidden"],
                                o["warm_up_step"], o["anneal_steps"],
                                o["anneal_rate"])
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
