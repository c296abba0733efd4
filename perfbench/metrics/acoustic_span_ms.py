"""The acoustic model's share of a request, from inside the program: the
median over the recorded requests of the device time (CUDA events) of the
span ``metatts.serve.acoustic`` around the engine's ``FastSpeech2``
forward (``serve.py``), in ms.  ``acoustic_ms`` times the same forward from
the harness's hooks."""

from perfbench import spans


def read(run):
    return spans.median(run, "metatts.serve", "metatts.serve.acoustic", "device_ms")
