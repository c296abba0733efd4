"""The device's idle share of the traced window: 1 minus the union of its
operations' intervals over the window's length, in %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
