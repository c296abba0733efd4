"""Minimal Praat TextGrid reader (replaces the ``tgt`` dependency).

Parses the standard long-form TextGrid emitted by the Montreal Forced
Aligner — the alignment format the reference consumes
(``preprocessor/preprocessor.py:196-199``).  Supports IntervalTiers; point
tiers are skipped.
"""

import re
from typing import List, NamedTuple


class Interval(NamedTuple):
    start_time: float
    end_time: float
    text: str


class IntervalTier(NamedTuple):
    name: str
    intervals: List[Interval]

    def get_intervals(self):
        return self.intervals


class TextGrid(NamedTuple):
    tiers: List[IntervalTier]

    def get_tier_by_name(self, name):
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier named {name!r}")


_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")
_STR_RE = re.compile(r'"((?:[^"]|"")*)"')


def _tokens(text):
    """Yield ('num', v) / ('str', s) tokens in file order."""
    for m in re.finditer(r'"(?:[^"]|"")*"|-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?',
                         text):
        tok = m.group(0)
        if tok.startswith('"'):
            yield ("str", tok[1:-1].replace('""', '"'))
        else:
            yield ("num", float(tok))


def read_textgrid(path):
    """Parse a long- or short-form TextGrid file."""
    with open(path, encoding="utf-8-sig", errors="replace") as f:
        text = f.read()

    # strip long-form index markers ("item [3]:", "intervals [12]:") so the
    # bracketed indices don't enter the numeric token stream
    text = re.sub(r"\[\s*\d+\s*\]", "[]", text)

    toks = list(_tokens(text))
    # Header: "ooTextFile" "TextGrid" xmin xmax <exists?> size
    i = 0
    strs = []
    while i < len(toks) and toks[i][0] == "str":
        strs.append(toks[i][1]); i += 1
    if "TextGrid" not in strs:
        raise ValueError(f"{path} is not a TextGrid")
    # skip global xmin xmax
    i += 2
    # tiers count (long form has <exists> flag text, short form a bare number)
    # find first "IntervalTier"/"TextTier" marker from here
    tiers = []
    while i < len(toks):
        if toks[i][0] == "str" and toks[i][1] in ("IntervalTier", "TextTier"):
            kind = toks[i][1]
            name = toks[i + 1][1] if toks[i + 1][0] == "str" else ""
            j = i + 2
            # tier xmin xmax n_items
            nums = []
            while j < len(toks) and toks[j][0] == "num" and len(nums) < 3:
                nums.append(toks[j][1]); j += 1
            n_items = int(nums[2]) if len(nums) == 3 else 0
            intervals = []
            if kind == "IntervalTier":
                for _ in range(n_items):
                    # xmin xmax "text"
                    vals = []
                    while j < len(toks) and toks[j][0] == "num" and len(vals) < 2:
                        vals.append(toks[j][1]); j += 1
                    label = ""
                    if j < len(toks) and toks[j][0] == "str":
                        label = toks[j][1]; j += 1
                    if len(vals) == 2:
                        intervals.append(Interval(vals[0], vals[1], label))
            else:  # TextTier (points) — skip n_items (time "text") pairs
                for _ in range(n_items):
                    if j < len(toks) and toks[j][0] == "num":
                        j += 1
                    if j < len(toks) and toks[j][0] == "str":
                        j += 1
            tiers.append(IntervalTier(name, intervals))
            i = j
        else:
            i += 1
    return TextGrid(tiers)
