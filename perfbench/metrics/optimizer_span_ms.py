"""The optimizer's share of a baseline step: the median over the steps
begun after the traced seconds of the host time of the span
``metatts.train.optimizer`` around ``NoamAdam.step`` (``train/optim.py``),
under the step's root ``metatts.train.step``, less its wait for the card in
``metatts.wait.clip`` (the clip's read of the norm, which waits for the
backward's queued work), in ms: the optimizer's own host loop."""

import statistics

from perfbench import spans


def read(run):
    found = spans.calls(run, "metatts.train.step", untraced=True)
    values = [v for v in (spans.own(c, "metatts.train.optimizer") for c in found or [])
              if v is not None]
    return statistics.median(values) if values else None
