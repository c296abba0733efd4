"""The traced part of a window: ``torch.profiler`` over the first units of
the window, read into device intervals and host ranges.

A ``Tracer`` starts with the window and stops at the first unit boundary
``seconds`` later.  ``Trace`` holds what the metrics read: every device
operation (name, start, end in seconds on the profiler's clock), the host
ranges, the traced window's length, the device's busy seconds (the union
of its operations' intervals), the top device operations and the longest
idle gaps by what the host was doing.
"""

import heapq
import time
from collections import defaultdict

import torch


def _times(e):
    """(start, end) of a kineto event in seconds."""
    if hasattr(e, "start_ns"):
        s, d = e.start_ns(), e.duration_ns()
        return s * 1e-9, (s + d) * 1e-9
    s, d = e.start_us(), e.duration_us()
    return s * 1e-6, (s + d) * 1e-6


class Trace:
    def __init__(self, events, window_s, units):
        self.window_s = window_s
        self.units = units              # the units the traced window ran
        self.device, self.host = [], []
        for e in events:
            kind = str(e.device_type()).split(".")[-1]
            start, end = _times(e)
            (self.device if kind == "CUDA" else self.host).append((e.name(), start, end))
        # a host range (record_function) also shows on the device's timeline
        # as an annotation over everything it launched: not an operation
        ranges = {name for name, _, _ in self.host}
        self.device = [d for d in self.device if d[0] not in ranges]
        self.device.sort(key=lambda x: x[1])
        self.host.sort(key=lambda x: x[1])
        self.kernels = [d for d in self.device if not d[0].startswith(("Memcpy", "Memset"))]
        self.busy_s, self._gaps = self._union()

    def _union(self):
        busy, gaps, cur = 0.0, [], None
        for _, s, e in self.device:
            if cur is None:
                cur = [s, e]
            elif s > cur[1]:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], s))
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        if cur is not None:
            busy += cur[1] - cur[0]
        return busy, gaps

    def time_in(self, pattern):
        """Device seconds of the operations whose names match ``pattern``
        (a compiled regex)."""
        return sum(e - s for n, s, e in self.device if pattern.search(n))

    def top_ops(self, n=10):
        tot = defaultdict(float)
        for name, s, e in self.device:
            tot[name] += e - s
        return [[k[:120], v] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]

    def idle_gaps(self, n=10):
        """The idle gaps between device operations, summed by the innermost
        host range open when each gap began."""
        tot = defaultdict(float)
        heap, i = [], 0
        for g0, g1 in self._gaps:
            while i < len(self.host) and self.host[i][1] <= g0:
                name, s, e = self.host[i]
                heapq.heappush(heap, (-s, e, name))
                i += 1
            while heap and heap[0][1] <= g0:
                heapq.heappop(heap)
            tot[heap[0][2] if heap else "(no host range)"] += g1 - g0
        return [[k[:120], v] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]


class Tracer:
    """Profiles the window's units from its start until ``seconds`` have
    passed (at a unit boundary)."""

    def __init__(self, seconds, device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.seconds, self.device = seconds, device
        self.prof = profile(activities=acts)
        self.trace, self.units, self.t0 = None, 0, None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def start(self):
        self._sync()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def unit_done(self):
        """Called after each unit; stops the profiler once its time is up."""
        if self.trace is not None or self.t0 is None:
            return
        self.units += 1
        if time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self):
        if self.trace is not None or self.t0 is None:
            return
        self._sync()
        stopped = time.perf_counter()
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        self.trace = Trace(events, stopped - self.t0, self.units)
        # host clock once the trace is read: the units after it ran untraced
        self.trace.resumed_at = time.perf_counter()
