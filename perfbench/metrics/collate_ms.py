"""The front end's share of a baseline step: the median over the traced run's
steps of the host clock around the harness's call of ``collate_batch``
(``data/collate.py``), in ms."""

import statistics


def read(run):
    values = run.cell.spans.get("collate_ms")
    return statistics.median(values) if values else None
