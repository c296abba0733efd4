"""Model input symbol table.

Reproduces the reference inventory (``text/symbols.py:10-29``): 360 symbols =
pad + special + punctuation + ASCII letters + 84 ARPAbet + 209 pinyin +
3 silence marks.  Phone symbols are prefixed with "@" for uniqueness.  The
model vocab is ``len(symbols) + 1`` (361) with index 0 = PAD.
"""

from . import arpabet, pinyin

PAD = 0  # embedding padding index (symbol "_")

_pad = "_"
_special = "-"
_punctuation = "!'(),.:;? "
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_silences = ["@sp", "@spn", "@sil"]

_arpabet = ["@" + s for s in arpabet.valid_symbols]
_pinyin = ["@" + s for s in pinyin.valid_symbols]

symbols = (
    [_pad]
    + list(_special)
    + list(_punctuation)
    + list(_letters)
    + _arpabet
    + _pinyin
    + _silences
)

symbol_to_id = {s: i for i, s in enumerate(symbols)}
id_to_symbol = {i: s for i, s in enumerate(symbols)}
