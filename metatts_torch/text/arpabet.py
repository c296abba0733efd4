"""ARPAbet phoneme inventory (CMUdict).

The 39 base phones; vowels additionally carry stress markers 0/1/2.  This is
the same 84-entry inventory the reference exposes as
``text/cmudict.py: valid_symbols`` — it is a fixed linguistic fact, ordered
alphabetically, and the ordering defines symbol IDs so it must not change.
"""

_VOWELS = [
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
]
_CONSONANTS = [
    "B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M", "N", "NG",
    "P", "R", "S", "SH", "T", "TH", "V", "W", "Y", "Z", "ZH",
]

# Alphabetical order over {vowel, vowel+stress, consonant}, matching CMUdict.
valid_symbols = sorted(
    _VOWELS
    + [v + s for v in _VOWELS for s in ("0", "1", "2")]
    + _CONSONANTS
)

_valid_symbol_set = set(valid_symbols)


class CMUDict:
    """Thin CMU pronouncing-dictionary reader (word -> ARPAbet strings).

    Same surface as the reference's ``text/cmudict.py:96-140``: ``len()``,
    ``lookup(word)`` returning a list of alternative pronunciations or None.
    """

    def __init__(self, file_or_path, keep_ambiguous=True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self):
        return len(self._entries)

    def lookup(self, word):
        return self._entries.get(word.upper())


_ALT_RE = __import__("re").compile(r"\([0-9]+\)")


def _parse_cmudict(f):
    entries = {}
    for line in f:
        if len(line) and (line[0] >= "A" and line[0] <= "Z" or line[0] == "'"):
            parts = line.split("  ")
            word = _ALT_RE.sub("", parts[0])
            pron = _get_pronunciation(parts[1])
            if pron:
                entries.setdefault(word, []).append(pron)
    return entries


def _get_pronunciation(s):
    parts = s.strip().split(" ")
    for part in parts:
        if part not in _valid_symbol_set:
            return None
    return " ".join(parts)
