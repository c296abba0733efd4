"""The plain reference of the training step: the baseline's supervised
step, followed by Adam with global-norm clipping and the Noam
schedule (Meta-TTS ``lightning/optimizer.py`` and ``scheduler.py``), in
float32.  It imports nothing of the program.

The seed chain is the system's: ``split(seed, 2)`` gives the init and the
training seed, a CPU ``torch.Generator`` seeded with the latter draws each
step's seed (``randint(0, 2**62)``), and a step's forwards take their
dropout from it as the program's do.
"""

import numpy as np
import torch

from .model import FP32, fastspeech2, loss, split


def step_seeds(seed, n):
    """The seeds of a system's first ``n`` training steps."""
    g = torch.Generator().manual_seed(split(seed, 2)[1])
    return [int(torch.randint(0, 2 ** 62, (1,), generator=g)) for _ in range(n)]


def noam_lr(step, cfg):
    o = cfg["train"]["optimizer"]
    d = cfg["model"]["transformer"]["encoder_hidden"]
    s = torch.tensor(max(int(step), 1), dtype=torch.float32)
    lr = torch.tensor(float(np.power(d, -0.5)), dtype=torch.float32) * torch.minimum(
        s ** -0.5, s * torch.tensor(float(o["warm_up_step"]) ** -1.5, dtype=torch.float32))
    n = sum(int(step) >= a for a in o["anneal_steps"])
    return lr * torch.tensor(o["anneal_rate"], dtype=torch.float32) ** n


class Adam:
    """Clip by global norm, Adam, the Noam learning rate."""

    def __init__(self, params, cfg):
        o = cfg["train"]["optimizer"]
        self.cfg = cfg
        self.b1, self.b2 = (float(b) for b in o["betas"])
        self.eps, self.clip = float(o["eps"]), float(o["grad_clip_thresh"])
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        """Updates ``params`` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if not bool(norm < self.clip):
            grads = {n: g / norm * self.clip for n, g in grads.items()}
        self.count += 1
        k = torch.tensor(float(self.count))
        c1, c2 = (float(1.0 - torch.tensor(b) ** k) for b in (self.b1, self.b2))
        lr = float(noam_lr(self.count - 1, self.cfg))
        for n, p in params.items():
            g = grads[n]
            self.mu[n].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.nu[n].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            p.sub_(lr * (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + self.eps))
        return grads


def _grads(total, params):
    names = list(params)
    g = torch.autograd.grad(total, [params[n] for n in names], allow_unused=True)
    return {n: torch.zeros_like(params[n]) if x is None else x for n, x in zip(names, g)}


def baseline_step(P, cfg, stats, batch, seed, q=FP32):
    """The supervised step's losses and gradients at ``P``."""
    P = {n: p.detach().requires_grad_() for n, p in P.items()}
    out = fastspeech2(P, cfg, stats, batch, q=q.a, train=True, seed=seed)
    ls = loss(out, batch)
    return [float(v.detach()) for v in ls], _grads(ls[0], P)
