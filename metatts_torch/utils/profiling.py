"""Profiling (the JAX package's ``utils/profiling.py``; reference: Lightning's
'simple' profiler and GPUStatsMonitor, ``main.py:37``, ``system.py:87-89``):

  * ``trace(logdir)`` -- a context manager around ``torch.profiler`` (CPU and,
    where there is a card, CUDA activities) that writes a Chrome trace
    under ``logdir``;
  * ``StepTimer`` -- host-side per-step wall-time stats (mean/p50/p95);
  * ``device_memory_stats()`` -- per-card memory in use, its peak and size.
"""

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir="output/profile"):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


class StepTimer:
    def __init__(self, window=200):
        self.window = window
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        if len(self.times) > self.window:
            self.times = self.times[-self.window:]

    def stats(self):
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {
            "steps": len(a),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p95_ms": float(np.percentile(a, 95) * 1e3),
            "steps_per_sec": float(1.0 / a.mean()),
        }


def device_memory_stats():
    """``cuda:<i>`` -> bytes in use, the peak since the last reset and the
    card's size; empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {
        "bytes_in_use": torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
        "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
    } for i in range(torch.cuda.device_count())}
