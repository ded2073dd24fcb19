"""The port's text frontend and sequence ops against the JAX package.

Text ids must be identical; ``sequence_mask`` and ``generate_path`` must
be exactly equal (integer and 0/1 results).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matcha_tpu.text as jax_text
import matcha_tpu.text.cleaners as jax_cleaners
import matcha_tpu_torch.text as port_text
import matcha_tpu_torch.text.cleaners as port_cleaners
from matcha_tpu.ops import seq as jax_seq
from matcha_tpu.utils.utils import intersperse as jax_intersperse
from matcha_tpu_torch.ops import seq as port_seq

SENTENCES = [
    "Hello, world!",
    "Dr. Smith paid $3.50 on the 21st of May, 1999.",
    "Mrs. O'Neil owes £1,200 - or 12.5 percent?",
    "The 3rd St. Co. Ltd. hired 1,000,000 people in 2005 and 2,000 in 1900.",
    "  Spaces   and\ttabs…  «quoted» “text” ¿qué?  ",
    "Café naïve résumé; Capt. Jr. Gen. Hon. Sgt. Esq. Ft. Col. Lt. Rev.",
    "$1 and $0.01, the 1st, 2nd, 11th, 22nd and 103rd.",
]


@pytest.mark.parametrize("cleaner", ["english_cleaners_no_espeak", "basic_cleaners",
                                     "transliteration_cleaners"])
def test_text_ids_match_jax(cleaner):
    for text in SENTENCES:
        want = jax_text.text_to_sequence(text, [cleaner])
        got = port_text.text_to_sequence(text, [cleaner])
        assert got == want, text
        assert port_text.intersperse(got, 0) == jax_intersperse(want, 0)
        assert port_text.sequence_to_text(got) == jax_text.sequence_to_text(want)


@pytest.mark.parametrize("cleaner", ["english_cleaners2", "english_cleaners_piper"])
def test_espeak_cleaners_raise_the_same_error(cleaner, monkeypatch):
    # a None entry in sys.modules makes the import fail, as without espeak
    monkeypatch.setitem(sys.modules, "phonemizer", None)
    monkeypatch.setitem(sys.modules, "piper_phonemize", None)
    monkeypatch.setattr(jax_cleaners, "_global_phonemizer", None)
    monkeypatch.setattr(port_cleaners, "_global_phonemizer", None)
    with pytest.raises(RuntimeError) as want:
        jax_text.text_to_sequence("hello", [cleaner])
    with pytest.raises(RuntimeError) as got:
        port_text.text_to_sequence("hello", [cleaner])
    assert str(got.value) == str(want.value)


def test_unknown_cleaner_raises():
    with pytest.raises(ValueError, match="Unknown cleaner"):
        port_text.text_to_sequence("hello", ["no_such_cleaner"])


def test_sequence_mask_exact(rng):
    lengths = rng.integers(0, 18, size=(6,)).astype(np.int32)
    want = np.asarray(jax_seq.sequence_mask(jnp.asarray(lengths), 17))
    got = port_seq.sequence_mask(torch.from_numpy(lengths), 17).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_path_exact(rng):
    B, T_x, T_y = 3, 9, 40
    durations = rng.integers(0, 6, size=(B, T_x)).astype(np.float32)
    x_len = np.array([9, 6, 3], np.int32)
    durations *= np.arange(T_x)[None, :] < x_len[:, None]
    y_len = np.minimum(durations.sum(1), T_y).astype(np.int32)
    mask = ((np.arange(T_x)[None, :, None] < x_len[:, None, None])
            & (np.arange(T_y)[None, None, :] < y_len[:, None, None])).astype(np.float32)
    want = np.asarray(jax_seq.generate_path(jnp.asarray(durations), jnp.asarray(mask)))
    got = port_seq.generate_path(torch.from_numpy(durations), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == y_len.sum()


def test_length_helpers_match():
    for n in range(0, 40):
        assert port_seq.fix_len_compatibility(n) == jax_seq.fix_len_compatibility(n)
    ids = np.array([5, 7, 9], np.int32)
    np.testing.assert_array_equal(port_seq.intersperse_ids(ids), jax_seq.intersperse_ids(ids))
    mel = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    np.testing.assert_array_equal(
        port_seq.denormalize(torch.from_numpy(mel), -5.5, 2.1).numpy(),
        np.asarray(jax_seq.denormalize(jnp.asarray(mel), -5.5, 2.1)))
