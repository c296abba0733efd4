"""Number -> words normalization for English text.

Equivalent behavior to the reference's ``text/numbers.py`` (which delegates to
the ``inflect`` package, unavailable here): commas stripped, currency
expansion, decimals as "point", ordinals, and year-style reading for
1000 < n < 3000.
"""

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = ["", " thousand", " million", " billion", " trillion",
           " quadrillion", " quintillion"]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n):
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _three_digits(n):
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rest:
        parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(n):
    """Cardinal words for a non-negative integer, no 'and' (inflect andword='')."""
    if n == 0:
        return "zero"
    groups = []
    while n:
        n, g = divmod(n, 1000)
        groups.append(g)
    parts = []
    for i in range(len(groups) - 1, -1, -1):
        if groups[i]:
            parts.append(_three_digits(groups[i]) + _SCALES[i])
    return ", ".join(parts)


def _year_to_words(n):
    """Pairwise reading (inflect group=2, zero='oh'): 1985 -> nineteen eighty-five."""
    hi, lo = divmod(n, 100)
    hi_w = _two_digits(hi)
    if lo == 0:
        return hi_w + " hundred" if hi else "zero"
    lo_w = _two_digits(lo)
    if lo < 10:
        lo_w = "oh " + _ONES[lo]
    return hi_w + " " + lo_w


def ordinal_to_words(n):
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    pre, _, final = last.rpartition("-")
    if final in _ORDINAL_IRREGULAR:
        final = _ORDINAL_IRREGULAR[final]
    elif final.endswith("y"):
        final = final[:-1] + "ieth"
    else:
        final = final + "th"
    last = pre + "-" + final if pre else final
    return head + " " + last if head else last


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        return "%s %s, %s %s" % (
            dollars, "dollar" if dollars == 1 else "dollars",
            cents, "cent" if cents == 1 else "cents")
    if dollars:
        return "%s %s" % (dollars, "dollar" if dollars == 1 else "dollars")
    if cents:
        return "%s %s" % (cents, "cent" if cents == 1 else "cents")
    return "zero dollars"


def _expand_ordinal(m):
    return ordinal_to_words(int(m.group(1)))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return _year_to_words(num)
    return number_to_words(num)


def normalize_numbers(text):
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
