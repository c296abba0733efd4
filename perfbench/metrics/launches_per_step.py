"""The host's dispatch: device kernels a step, from the profiler's trace
of the traced window (copies and fills not counted)."""


def read(run):
    t = run.trace
    if t is None or not t.units or not t.kernels:
        return None
    return len(t.kernels) / t.units
