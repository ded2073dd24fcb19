"""Sentence segmentation for long-form synthesis.

The port's own copy of ``matcha_tpu/text/segment.py``: long inputs do not
fit one length bucket, so the CLI's ``--long-form`` synthesises them
sentence by sentence through the same fixed-shape graphs. The splitter is
deliberately simple (an abbreviation-aware regex), host-side and imports
no framework.
"""

import re
from typing import List

_ABBREVS = {
    "mr", "mrs", "dr", "st", "co", "jr", "maj", "gen", "drs", "rev", "lt",
    "hon", "sgt", "capt", "esq", "ltd", "col", "ft", "etc", "vs", "e.g", "i.e",
}
_SENT_RE = re.compile(r"([.!?]+[\"'”»)]*)\s+")


def _ends_with_abbrev(prefix: str) -> bool:
    last_word = prefix.rsplit(None, 1)[-1] if prefix.split() else ""
    return last_word.lower().rstrip(".") in _ABBREVS


def split_sentences(text: str, max_chars: int = 500) -> List[str]:
    """Split text into sentence-ish chunks no longer than ``max_chars``.

    Sentences are merged greedily up to the limit; a single overlong
    sentence is hard-wrapped at word boundaries.
    """
    text = text.strip()
    if not text:
        return []
    parts: List[str] = []
    last = 0
    for m in _SENT_RE.finditer(text):
        if _ends_with_abbrev(text[last : m.start(1)]):
            continue
        parts.append(text[last : m.end(1)].strip())
        last = m.end()
    tail = text[last:].strip()
    if tail:
        parts.append(tail)

    chunks: List[str] = []
    cur = ""
    for s in parts:
        while len(s) > max_chars:  # hard-wrap pathological sentences
            cut = s.rfind(" ", 0, max_chars)
            cut = cut if cut > 0 else max_chars
            if cur:
                chunks.append(cur)
                cur = ""
            chunks.append(s[:cut].strip())
            s = s[cut:].strip()
        if not cur:
            cur = s
        elif len(cur) + 1 + len(s) <= max_chars:
            cur = f"{cur} {s}"
        else:
            chunks.append(cur)
            cur = s
    if cur:
        chunks.append(cur)
    return chunks
