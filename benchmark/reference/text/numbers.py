"""Number normalization for the text frontend.

Behavioural equivalent of the reference's inflect-based normalizer
(reference: matcha/text/numbers.py:64-70) without the ``inflect``
dependency: a self-contained English number-to-words engine. Like the
reference, this module is not wired into the espeak cleaners (espeak
handles numbers itself); it exists for the keithito-style frontend parity
and for the pure-Python cleaners.
"""

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
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
_SCALES = [
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits_to_words(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _three_digits_to_words(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rest:
        parts.append(_two_digits_to_words(rest))
    return " ".join(parts)


def number_to_words(n: int, andword: str = "") -> str:
    """Spell out a non-negative integer in English words."""
    if n == 0:
        return "zero"
    parts = []
    for scale, name in _SCALES:
        count, n = divmod(n, scale)
        if count:
            parts.append(_three_digits_to_words(count) + " " + name)
    if n:
        if parts and andword:
            parts.append(andword)
        parts.append(_three_digits_to_words(n))
    return " ".join(parts)


def number_to_ordinal_words(n: int) -> str:
    """Spell out an integer as an English ordinal ('3' -> 'third')."""
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    hyph_head, _, hyph_last = last.rpartition("-")
    if hyph_last in _ORDINAL_IRREGULAR:
        ordinal_last = _ORDINAL_IRREGULAR[hyph_last]
    elif hyph_last.endswith("y"):
        ordinal_last = hyph_last[:-1] + "ieth"
    elif hyph_last.endswith(("hundred", "thousand", "million", "billion", "trillion")):
        ordinal_last = hyph_last + "th"
    else:
        ordinal_last = hyph_last + "th"
    last = (hyph_head + "-" if hyph_head else "") + ordinal_last
    return (head + " " if head else "") + last


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _expand_decimal_point(m: re.Match) -> str:
    return m.group(1).replace(".", " point ")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"  # Unexpected format
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        return f"{dollars} {dollar_unit}"
    if cents:
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{cents} {cent_unit}"
    return "zero dollars"


def _year_to_words(num: int) -> str:
    """Read a 4-digit number in two-digit groups ('1999' -> 'nineteen
    ninety-nine', '1905' -> 'nineteen oh five')."""
    digits = str(num)
    words = []
    for i in range(0, len(digits), 2):
        pair = digits[i : i + 2]
        n = int(pair)
        if len(pair) == 2 and pair[0] == "0":
            words.append("oh " + _ONES[n] if n else "oh oh")
        else:
            words.append(_two_digits_to_words(n))
    return " ".join(words)


def _expand_ordinal(m: re.Match) -> str:
    return number_to_ordinal_words(int(m.group(0)[:-2]))


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return _year_to_words(num)
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
