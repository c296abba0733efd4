"""Profiling (the JAX package's ``utils/profiling.py``; reference: Lightning's
'simple' profiler and GPUStatsMonitor, ``main.py:37``, ``system.py:87-89``):

  * ``trace(logdir)`` -- a context manager around ``torch.profiler`` (CPU and,
    where there is a card, CUDA activities) that writes a Chrome trace
    under ``logdir``;
  * ``StepTimer`` -- host-side per-step wall-time stats (mean/p50/p95);
  * ``device_memory_stats()`` -- per-card memory in use, its peak and size;
  * ``span(name)`` -- a named range of the program's own work, recorded
    while recording is on (``start`` / ``stop``, or a ``torch.profiler``
    that is recording when a span opens) and read back by ``records()``;
  * ``profile(**kwargs)`` -- ``torch.profiler.profile``, ending the spans'
    recording that a span turned on under it (``trace`` runs in it).

Spans.  With recording off, ``span()`` checks one flag and returns the
shared ``NULL`` context, which records nothing.  With recording on, a span
opens a ``record_function`` of its name while a profiler records (so the
profiler's trace shows it as a host range, on the clock of the device's
operations) and appends a record to a bounded buffer: its name, its start
and end on the profiler's clock (``clock_ns``), its parent, its root (the
outermost span open on its thread when it began: every span of one
``synthesize`` call or one training step carries that call's root), the
counts given to ``count``, with ``device=True`` the device time between
two CUDA events (the host clock where no CUDA device is in use), resolved
only when the records are read, and with ``wait=True`` a mark that the
host blocks on the card inside it (a copy to or from pageable memory,
``.cpu()``, ``bool()`` of a device tensor).

A recording that a span turns on under a bare ``torch.profiler`` (the
benchmark's traced window) lasts past it, until ``stop()``, so the work
after the profiled part records too; under ``profile`` or ``trace`` it
ends with them.  Each recording begins with an empty buffer.
"""

import collections
import contextlib
import itertools
import os
import threading
import time

import numpy as np
import torch

import torch.autograd.profiler as _profiler

# the newest records kept: a long run in trace mode drops the oldest
BUFFER = 100_000

# the clock of the profiler's host ranges (kineto reads the Unix epoch)
clock_ns = time.time_ns


@contextlib.contextmanager
def trace(logdir="output/profile"):
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def profile(**kwargs):
    """``torch.profiler.profile(**kwargs)``, after which the spans record
    only if they did before it: a recording that a span turned on under it
    stops with it."""
    was_on = _on
    try:
        with torch.profiler.profile(**kwargs) as prof:
            yield prof
    finally:
        if not was_on:
            stop()


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


# ------------------------------------------------------------------ spans

class _Null:
    """The span of recording off: records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **ints):
        pass


NULL = _Null()
_on = False
_buffer = collections.deque(maxlen=BUFFER)
_ids = itertools.count(1)
_local = threading.local()


def start():
    """Turn recording on with an empty buffer."""
    global _on
    _buffer.clear()
    _on = True


def stop():
    """Turn recording off; the records stay readable."""
    global _on
    _on = False


def span(name, *, device=False, wait=False):
    """A context manager over the work named ``name`` (module docstring);
    its handle's ``count(**ints)`` adds to the record's counts."""
    if not (_on or _profiler._is_profiler_enabled):
        return NULL
    return _Span(name, device, wait)


class _Span:
    __slots__ = ("name", "device", "wait", "id", "parent", "root", "counts", "start_ns",
                 "end_ns", "device_ms", "_events", "_range")

    def __init__(self, name, device, wait):
        self.name, self.device, self.wait = name, device, wait
        self.counts, self.device_ms, self._events, self._range = {}, None, None, None

    def __enter__(self):
        if not _on:
            start()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        stack.append(self)
        self.start_ns = clock_ns()
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        self.end_ns = clock_ns()
        if self._events is not None:
            self._events[1].record()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _local.stack.pop()
        _buffer.append(self)
        return False

    def count(self, **ints):
        for k, v in ints.items():
            self.counts[k] = self.counts.get(k, 0) + int(v)

    def record(self):
        if self._events is not None:
            self._events[1].synchronize()
            self.device_ms = self._events[0].elapsed_time(self._events[1])
            self._events = None
        elif self.device and self.device_ms is None:
            self.device_ms = (self.end_ns - self.start_ns) * 1e-6
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "host_ms": (self.end_ns - self.start_ns) * 1e-6, "device_ms": self.device_ms,
                "wait": self.wait, "counts": dict(self.counts)}


def records():
    """The buffer's records, oldest first, each a dict: ``name``, ``id``,
    ``parent`` and ``root`` (ids; ``parent`` None at a root), ``start_ns``
    and ``end_ns`` (``clock_ns``), ``host_ms``, ``device_ms`` (None unless
    the span was opened with ``device=True``), ``wait`` and ``counts``.
    Waits for the card where a device span's events have not completed."""
    return [s.record() for s in list(_buffer)]
