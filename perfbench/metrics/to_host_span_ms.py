"""The copies out of a request: the median over the requests begun after
the traced seconds of the host time of its ``metatts.to_host.*`` spans,
summed (the wavs' copy, int16 cast and slicing in ``Vocoder.infer``; the
mels' copy in ``SynthesisEngine.synthesize``), in ms."""

from perfbench import spans


def read(run):
    return spans.median(run, "metatts.serve", "metatts.to_host.")
