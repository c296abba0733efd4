"""Training cells: one system built once, driven from the seed through its
first steps in set-up (the readings the check compares), then through the
window, each step's samples collated on the host by the system's collate.

The check: the reference follows the first three steps from the same
weights, batches and step seeds, and compares each step's loss, the norm
of the first step's gradient as the optimizer holds it (Adam's first
moment after one step over 1 - beta1), and the norm of each parameter's
change after three steps; norms by leaf, the gap against the reference's
norm of that leaf or the median leaf's, whichever is larger.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the change: Adam moves them by rounding alone.
"""

import statistics
import sys
import time

import torch

from .. import traffic, weights as W
from ..reference import train as RT
from ..reference import model as R
from . import common as C

CHECK_STEPS = 3


class TrainCell:
    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        self.records = []
        self.spans = {"collate_ms": []}
        self.got = {"loss": [], "grad": None, "change": None}

    # ------------------------------------------------------------ hooks

    def make_system(self):
        raise NotImplementedError

    def collate(self, unit):
        """The window's feed: the unit's samples -> the step's arguments."""
        raise NotImplementedError

    def call(self, args):
        return self.system.train_step(*args)

    def lengths(self, unit):
        raise NotImplementedError

    def reference_step(self, P, unit, seed, q):
        raise NotImplementedError

    # ------------------------------------------------------------ set-up

    def setup(self):
        cfg = self.cfg
        self.pool, _ = traffic.draw(self.mix, cfg, self.seed)
        self.system = self.make_system()
        if getattr(self, "fault", None):
            self.fault(self)
        w0 = C.acoustic_weights(self.system.model, self.seed, self.device)
        W.load_into(self.system.model, w0)
        self.w0_host = {n: t.cpu() for n, t in w0.items()}
        del w0
        b1 = float(cfg["train"]["optimizer"]["betas"][0])
        for k in range(CHECK_STEPS + self.mix["warm_steps"]):
            args = self.collate(self.pool[k % len(self.pool)])
            losses = self.call(args)
            if k < CHECK_STEPS:
                self.got["loss"].append(float(losses.total))
            if k == 0:
                opt = self.system.optimizer
                self.got["grad"] = {n: float((m / (1.0 - b1)).double().norm())
                                    for n, m in opt.mu.items()}
            if k == CHECK_STEPS - 1:
                with torch.no_grad():
                    self.got["change"] = {
                        n: float((p.detach().cpu() - self.w0_host[n]).double().norm())
                        for n, p in self.system.model.named_parameters()}
        self.next = CHECK_STEPS + self.mix["warm_steps"]

    # ------------------------------------------------------------ window

    def run_window(self, seconds, tracer=None):
        self.attempted = self.failed = 0
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        while True:
            i = self.next % len(self.pool)
            self.next += 1
            self.attempted += 1
            unit = self.pool[i]
            tc = time.perf_counter()
            with torch.profiler.record_function("perfbench.collate"):
                args = self.collate(unit)
            self.spans["collate_ms"].append(1e3 * (time.perf_counter() - tc))
            try:
                with torch.profiler.record_function("perfbench.step"):
                    self.call(args)
                self.records.append({"unit": i, "frames": traffic.valid_frames(unit)})
            except Exception as exc:            # counted, and the run is not correct
                self.failed += 1
                print(f"perfbench: a step failed: {exc!r}", file=sys.stderr)
            if tracer is not None:
                sync()
                tracer.unit_done()
            if time.perf_counter() - t0 >= seconds:
                sync()
                break
        self.window_end = time.perf_counter()
        self.window_s = self.window_end - t0

    def free(self):
        del self.system
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ check

    def reference_readings(self, q=R.FP32):
        """The reference's losses, first clipped gradient norms and
        three-step changes, from the same start."""
        P = {n: t.to(self.device, copy=True) for n, t in self.w0_host.items()}
        adam = RT.Adam(P, self.cfg)
        seeds = RT.step_seeds(self.seed % 2 ** 63, CHECK_STEPS)
        out = {"loss": [], "grad": None}
        for k in range(CHECK_STEPS):
            losses, grads = self.reference_step(P, self.pool[k % len(self.pool)], seeds[k], q)
            out["loss"].append(losses[0])
            clipped = adam.step(P, grads)
            if k == 0:
                out["grad"] = C.norms(clipped)
                out["ref_grad"] = C.norms(grads)
            del grads, clipped
        out["change"] = {n: float((P[n].cpu() - self.w0_host[n]).double().norm()) for n in P}
        return out

    def check(self, got=None):
        ref = C.with_tf32_off(self.reference_readings)
        return readings(got or self.got, ref)


def readings(got, ref):
    """The numbers compared: loss, first gradient, three-step change."""
    med = statistics.median(ref["ref_grad"].values())
    moved = {n for n, v in ref["ref_grad"].items() if v >= 1e-3 * med}
    out = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])),
        "grad_gap": C.worst_leaf_gap(got["grad"], ref["grad"]),
        "change_gap": C.worst_leaf_gap(got["change"], ref["change"], keep=moved),
    }
    return out


def as_program(cell, q):
    """The readings of the reference put in the program's place at
    precision ``q``: what the control compares."""
    r = C.with_tf32_off(lambda: cell.reference_readings(q))
    return {"loss": r["loss"], "grad": r["grad"], "change": r["change"]}
