"""MelGAN's share of a request: the median over the recorded requests of
the device time (CUDA events) of the span ``metatts.vocoder.net`` around
the vocoder's forward alone (``models/vocoder.py`` ``Vocoder.infer``), in
ms.  ``vocoder_ms`` also counts the copy of the wavs to the host."""

from perfbench import spans


def read(run):
    return spans.median(run, "metatts.serve", "metatts.vocoder.net", "device_ms")
