"""Texts from the frozen word list ``benchmark/traffic/words.txt``.

A traffic mix gives the length of its texts in characters as
``{"min", "max", "mean", "sd"}``: each length is a normal draw clipped to
[min, max]; words drawn uniformly from the list fill a sentence to that
length, with a comma after about one word in twelve; each text ends with a stop. Texts of one call
are distinct, so that each answer can be told apart by its text.
"""

from pathlib import Path

import numpy as np

WORDS_FILE = Path(__file__).resolve().parents[1] / "traffic" / "words.txt"


def load_words(path: Path = WORDS_FILE) -> list:
    seen, words = set(), []
    for w in path.read_text().split():
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def make_text(rng: np.random.Generator, words: list, n_chars: int) -> str:
    """One sentence of ``n_chars`` characters or a few fewer (never more,
    with its final stop): words that would overrun are drawn again."""
    out, size, misses = [], 0, 0
    while size < n_chars - 3 and misses < 50:
        w = words[int(rng.integers(len(words)))]
        comma = bool(out) and rng.random() < 1 / 12
        extra = len(w) + (1 if out else 0) + comma
        if size + extra > n_chars - 1:
            misses += 1
            continue
        if comma:
            out[-1] += ","
        out.append(w)
        size += extra
    text = " ".join(out)
    return text[0].upper() + text[1:] + "."


def draw_lengths(rng: np.random.Generator, n: int, chars: dict) -> np.ndarray:
    """``n`` text lengths: normal draws clipped to [min, max]."""
    return np.clip(np.round(rng.normal(chars["mean"], chars["sd"], size=n)), chars["min"],
                   chars["max"]).astype(int)


def texts_of_lengths(rng: np.random.Generator, lengths, words: list = None) -> list:
    """Distinct texts, one of about each of ``lengths`` characters."""
    words = words or load_words()
    texts, seen = [], set()
    for target in lengths:
        while True:
            t = make_text(rng, words, int(target))
            if t not in seen:
                break
        seen.add(t)
        texts.append(t)
    return texts


def make_texts(rng: np.random.Generator, n: int, chars: dict, words: list = None) -> list:
    """``n`` distinct texts with lengths drawn as ``chars`` says."""
    return texts_of_lengths(rng, draw_lengths(rng, n, chars), words)


def fixed_lengths(name: str, n: int, chars: dict) -> np.ndarray:
    """The lengths of a traffic mix's ``n`` texts, the same for every
    seed (each run draws its own order and words): every seed does the
    same work."""
    from benchmark.harness.common import derive_seed
    return draw_lengths(np.random.default_rng(derive_seed(0, "lengths", name)), n, chars)
