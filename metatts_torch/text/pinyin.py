"""Mandarin pinyin phone inventory (initials + tonal finals + erhua 'rr').

Same 209-entry inventory as the reference's ``text/pinyin.py`` (23 initials,
37 final bases x 5 tones, plus "rr"); ordering defines symbol IDs.  The finals
are generated as base x tone rather than written out long-hand.
"""

initials = [
    "b", "c", "ch", "d", "f", "g", "h", "j", "k", "l", "m", "n",
    "p", "q", "r", "s", "sh", "t", "w", "x", "y", "z", "zh",
]

# Final bases in the reference's file order (GB/T pinyin romanization with
# 'ii'/'iii' for the apical vowels and 'v' for ü).
_final_bases = [
    "a", "ai", "an", "ang", "ao",
    "e", "ei", "en", "eng", "er",
    "i", "ia", "ian", "iang", "iao", "ie", "ii", "iii", "in", "ing",
    "iong", "iou",
    "o", "ong", "ou",
    "u", "ua", "uai", "uan", "uang", "uei", "uen", "uo",
    "v", "van", "ve", "vn",
]

finals = [b + str(t) for b in _final_bases for t in range(1, 6)]

valid_symbols = initials + finals + ["rr"]
