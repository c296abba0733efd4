"""The front end's share of a request: the median over the requests begun
after the traced seconds of the host time of the program's span
``metatts.serve.frontend`` (``serve.py``: text to ids, ``collate_batch``,
the batch to the card), in ms."""

from perfbench import spans


def read(run):
    return spans.median(run, "metatts.serve", "metatts.serve.frontend")
