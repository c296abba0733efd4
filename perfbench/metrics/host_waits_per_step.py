"""The times a baseline step blocks the host on the card: the median over
the recorded steps of the wait spans (``span(..., wait=True)``: copies to
and from pageable memory, ``bool()`` of a device tensor) under the step's
root ``metatts.train.step`` (``algorithms/baseline.py``)."""

import statistics

from perfbench import spans


def read(run):
    found = spans.calls(run, "metatts.train.step")
    if not found:
        return None
    return float(statistics.median(sum(r["wait"] for r in c) for c in found))
