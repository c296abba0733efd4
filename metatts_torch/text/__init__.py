"""Text frontend: text -> symbol-ID sequences.

Same contract as the reference ``text/__init__.py:15-41``: plain text is run
through the named cleaners; ``{ARPAbet or pinyin}`` spans in curly braces are
parsed as space-separated phone symbols.
"""

import re

from . import cleaners
from .symbols import symbols, symbol_to_id, id_to_symbol

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def text_to_sequence(text, cleaner_names):
    """Convert a string (optionally with {PHONE ...} spans) to symbol IDs."""
    sequence = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _phones_to_sequence(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence):
    """Inverse mapping, re-bracing phone symbols."""
    out = []
    for sid in sequence:
        s = id_to_symbol.get(int(sid))
        if s is None:
            continue
        if len(s) > 1 and s[0] == "@":
            s = "{%s}" % s[1:]
        out.append(s)
    return "".join(out).replace("}{", " ")


def _clean_text(text, cleaner_names):
    for name in cleaner_names:
        fn = getattr(cleaners, name, None)
        if fn is None:
            raise ValueError("Unknown cleaner: %s" % name)
        text = fn(text)
    return text


def _symbols_to_sequence(syms):
    return [symbol_to_id[s] for s in syms if _should_keep(s)]


def _phones_to_sequence(text):
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep(s):
    return s in symbol_to_id and s not in ("_", "~")
