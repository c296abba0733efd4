"""The front end's share of a baseline step, from inside the program: the
median over the calls begun after the traced seconds of the host time of
the span ``metatts.data.collate`` around ``collate_batch``
(``data/collate.py``), where it opens outside any other span (the harness
collates outside the step), in ms.  ``collate_ms`` times the same call from
the harness."""

from perfbench import spans


def read(run):
    return spans.median(run, "metatts.data.collate", "metatts.data.collate")
