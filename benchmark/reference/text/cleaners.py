"""Text cleaner pipelines (own copy of ``matcha_tpu/text/cleaners.py``).

The espeak-backed G2P cleaners (``english_cleaners2``,
``english_cleaners_piper``) need the espeak-ng C library through
``phonemizer``/``piper_phonemize``; they initialise lazily and raise a
clear error when the backend is not installed. The pure-Python cleaners
(``basic_cleaners``, ``transliteration_cleaners``,
``english_cleaners_no_espeak``) always work.
"""

import re
import unicodedata

from benchmark.reference.text.numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), expansion)
    for abbr, expansion in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

_global_phonemizer = None
_PHONEMIZER_ERR = (
    "The '{name}' cleaner needs the espeak-ng G2P backend ({pkg}), which is "
    "not installed in this environment. Install espeak-ng + {pkg}, or use a "
    "pure-Python cleaner ('english_cleaners_no_espeak', 'basic_cleaners', "
    "'transliteration_cleaners'), or precompute phonemized filelists."
)


def _get_phonemizer():
    """Initialise the espeak backend once (per-call init is very slow)."""
    global _global_phonemizer
    if _global_phonemizer is None:
        import logging

        try:
            import phonemizer
        except ImportError as e:
            raise RuntimeError(
                _PHONEMIZER_ERR.format(name="english_cleaners2", pkg="phonemizer")
            ) from e
        critical_logger = logging.getLogger("phonemizer")
        critical_logger.setLevel(logging.CRITICAL)
        _global_phonemizer = phonemizer.backend.EspeakBackend(
            language="en-us",
            preserve_punctuation=True,
            with_stress=True,
            language_switch="remove-flags",
            logger=critical_logger,
        )
    return _global_phonemizer


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text: str) -> str:
    """Transliterate to ASCII: ``unidecode`` when installed, else NFKD
    decomposition with the combining marks stripped."""
    try:
        from unidecode import unidecode

        return unidecode(text)
    except ImportError:
        decomposed = unicodedata.normalize("NFKD", text)
        stripped = "".join(c for c in decomposed if not unicodedata.combining(c))
        return stripped.encode("ascii", "ignore").decode("ascii")


def basic_cleaners(text: str) -> str:
    """Lowercase and collapse whitespace, no transliteration."""
    text = lowercase(text)
    text = collapse_whitespace(text)
    return text


def transliteration_cleaners(text: str) -> str:
    """Pipeline for non-English text that transliterates to ASCII."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = collapse_whitespace(text)
    return text


def english_cleaners_no_espeak(text: str) -> str:
    """English without G2P: ascii + lowercase + numbers + abbreviations.
    Output stays in the grapheme part of the symbol table."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


def english_cleaners2(text: str) -> str:
    """English: abbreviation expansion + espeak IPA G2P with punctuation
    and stress."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_abbreviations(text)
    phonemes = _get_phonemizer().phonemize([text], strip=True, njobs=1)[0]
    phonemes = collapse_whitespace(phonemes)
    return phonemes


def english_cleaners_piper(text: str) -> str:
    """English through the piper_phonemize espeak wrapper."""
    try:
        import piper_phonemize
    except ImportError as e:
        raise RuntimeError(
            _PHONEMIZER_ERR.format(name="english_cleaners_piper", pkg="piper_phonemize")
        ) from e
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_abbreviations(text)
    phonemes = "".join(piper_phonemize.phonemize_espeak(text=text, voice="en-US")[0])
    phonemes = collapse_whitespace(phonemes)
    return phonemes
