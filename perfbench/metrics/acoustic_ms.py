"""The acoustic model's share of a request: the median over the traced run's
requests of the CUDA-event time around the engine's ``FastSpeech2.forward``
(``models/fastspeech2.py``), in ms."""

import statistics


def read(run):
    values = run.cell.spans.get("acoustic_ms")
    return statistics.median(values) if values else None
