"""Text frontend: string -> symbol-id sequences (host side).

Same surface as the reference frontend: ``text_to_sequence``,
``cleaned_text_to_sequence``, ``sequence_to_text``, plus the blank
``intersperse``.
"""

from benchmark.reference.text import cleaners
from benchmark.reference.text.symbols import symbols

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = dict(enumerate(symbols))


def text_to_sequence(text: str, cleaner_names) -> list:
    """Clean ``text`` with the named cleaners and map it to symbol ids
    (symbols outside the table are dropped)."""
    clean_text = _clean_text(text, cleaner_names)
    return [_symbol_to_id[symbol] for symbol in clean_text if symbol in _symbol_to_id]


def cleaned_text_to_sequence(cleaned_text: str) -> list:
    """Map an already-cleaned string to symbol ids."""
    return [_symbol_to_id[symbol] for symbol in cleaned_text]


def sequence_to_text(sequence) -> str:
    """Map symbol ids back to a string."""
    return "".join(_id_to_symbol[int(symbol_id)] for symbol_id in sequence)


def intersperse(lst: list, item) -> list:
    """Put ``item`` between every element of ``lst`` and at both ends
    (length 2*len(lst)+1), the blank-token interleave."""
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = lst
    return result


def _clean_text(text: str, cleaner_names) -> str:
    for name in cleaner_names:
        cleaner = getattr(cleaners, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text
