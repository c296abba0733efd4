"""The whole request's or step's share of the card's peak over the window:
the operations the algorithm needs, counted from shapes over valid
phonemes and frames (``roofline.py``), each part over the dense peak of
the precision the configuration states for it, summed over the window's
units begun after the traced part of the window and its reading, divided
by their time (the profiler slows the host while it records), in %."""


def read(run):
    t, cell = run.trace, run.cell
    rest = cell.records[t.units:]
    seconds = cell.window_end - t.resumed_at
    if not rest or seconds <= 0:
        return None
    return 100.0 * cell.ideal_s(rest) / seconds
