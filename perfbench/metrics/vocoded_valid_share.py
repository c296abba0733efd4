"""The share of the frames the vocoder runs over that are valid: the sum
over the recorded requests of the counts ``frames_valid`` (the served mels'
lengths) over the sum of ``frames_run`` (batch times the padded mel length)
of the span ``metatts.vocoder.net`` (``models/vocoder.py``), in %."""

from perfbench import spans


def read(run):
    found = spans.calls(run, "metatts.serve")
    counts = [r["counts"] for c in found or [] for r in c if r["name"] == "metatts.vocoder.net"]
    ran = sum(c.get("frames_run", 0) for c in counts)
    if not ran:
        return None
    return 100.0 * sum(c.get("frames_valid", 0) for c in counts) / ran
