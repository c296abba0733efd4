"""The vocoder's share of a request: the median over the traced run's requests
of the CUDA-event time around ``Vocoder.infer`` (``models/vocoder.py``), the
copy of the wavs to the host included, in ms."""

import statistics


def read(run):
    values = run.cell.spans.get("vocoder_ms")
    return statistics.median(values) if values else None
