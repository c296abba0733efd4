"""What the readers of the program's spans share (``metrics/*_span_*.py``,
``vocoded_valid_share.py``, ``host_waits_per_step.py``): the records of
``metatts_torch.utils.profiling`` grouped by the call whose root span they
carry.  A program without spans, or one that recorded none, gives None, and
so does every reader of them.

Host times are read over the calls begun after the traced seconds and
their reading (``Trace.resumed_at``), where the profiler no longer slows the
host; device times and counts over every recorded call.
"""

import statistics
import time


def _profiling():
    try:
        from metatts_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") else None


def calls(run, root, untraced=False):
    """A list per recorded call whose root span is named ``root``: the
    call's records; with ``untraced``, only the calls begun after the traced
    seconds.  None where there are none."""
    profiling = _profiling()
    recs = profiling.records() if profiling is not None else None
    if not recs:
        return None
    cut = None
    if untraced:
        # Trace.resumed_at (the host's perf_counter) on the records' clock
        cut = profiling.clock_ns() - 1e9 * (time.perf_counter() - run.trace.resumed_at)
    out = {r["id"]: [] for r in recs if r["parent"] is None and r["name"] == root
           and (cut is None or r["start_ns"] >= cut)}
    for r in recs:
        if r["root"] in out:
            out[r["root"]].append(r)
    return list(out.values()) or None


def total(call, name, key="host_ms"):
    """The sum of ``key`` over a call's records named ``name`` (or, for a
    name that ends in a dot, whose names start with it); None where none
    is."""
    values = [r[key] for r in call
              if (r["name"].startswith(name) if name.endswith(".") else r["name"] == name)]
    return sum(values) if values else None


def own(call, name):
    """The host time of a call's records named ``name`` less that of the
    outermost wait spans inside them (``span(..., wait=True)``): the host's
    own work there, without its waits for the card.  None where none is."""
    whole = total(call, name)
    if whole is None:
        return None
    by_id = {r["id"]: r for r in call}
    waits = 0.0
    for r in call:
        if not r["wait"]:
            continue
        up = by_id.get(r["parent"])
        while up is not None and up["name"] != name and not up["wait"]:
            up = by_id.get(up["parent"])
        if up is not None and up["name"] == name:
            waits += r["host_ms"]
    return whole - waits


def median(run, root, name, key="host_ms"):
    """The median over the calls of ``total(call, name, key)``: host times
    over the untraced calls, device times over every call."""
    found = calls(run, root, untraced=key == "host_ms")
    values = [v for v in (total(c, name, key) for c in found or []) if v is not None]
    return statistics.median(values) if values else None
