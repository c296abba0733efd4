"""Text cleaners (English pipeline matching the reference ``text/cleaners.py``).

``convert_to_ascii`` uses a unicodedata-based transliteration instead of the
``unidecode`` package (unavailable here): NFKD-decompose, strip combining
marks, map a handful of common non-decomposable characters, then drop any
remaining non-ASCII.  For already-ASCII corpora (LibriTTS/VCTK) the output is
identical to unidecode's.
"""

import re
import unicodedata

from .numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_ABBREVIATIONS = [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
    ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
]
_abbrev_res = [(re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
               for abbr, full in _ABBREVIATIONS]

# Non-decomposable characters unidecode maps specially.
_CHAR_MAP = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O",
    "ß": "ss", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D", "þ": "th", "Þ": "Th",
    "ł": "l", "Ł": "L", "ı": "i", "—": "-", "–": "-", "‘": "'", "’": "'",
    "“": '"', "”": '"', "…": "...", "«": '"', "»": '"', " ": " ",
}


def expand_abbreviations(text):
    for regex, replacement in _abbrev_res:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text):
    return normalize_numbers(text)


def lowercase(text):
    return text.lower()


def collapse_whitespace(text):
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text):
    text = "".join(_CHAR_MAP.get(c, c) for c in text)
    decomposed = unicodedata.normalize("NFKD", text)
    stripped = "".join(c for c in decomposed if not unicodedata.combining(c))
    return stripped.encode("ascii", "ignore").decode("ascii")


def basic_cleaners(text):
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text):
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text):
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text
