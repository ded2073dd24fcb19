"""``python -m matcha_tpu_torch.text.phonemize``: clean a training
filelist once, offline.

The port of ``matcha_tpu/text/phonemize.py``: runs the cleaner pipeline
(espeak G2P for ``english_cleaners2``) over a ``path|[spk|]text``
filelist once and writes a filelist whose text column is the cleaned
(phonemised) string, so that training need not re-run G2P every epoch;
train on it with ``data.cleaners=[]``.

    python -m matcha_tpu_torch.text.phonemize in.txt out.txt \\
        [--cleaner english_cleaners2] [--n-spks 1]
"""

import argparse
import sys

from matcha_tpu_torch.text import _clean_text
from matcha_tpu_torch.training.data import parse_filelist


def phonemize_filelist(input_path: str, output_path: str,
                       cleaner: str = "english_cleaners2", n_spks: int = 1) -> int:
    """Write ``output_path`` and return the number of utterances."""
    entries = parse_filelist(input_path)
    n = 0
    with open(output_path, "w", encoding="utf-8") as f:
        for entry in entries:
            if n_spks > 1:
                path, spk, text = entry[0], entry[1], "|".join(entry[2:])
                f.write(f"{path}|{spk}|{_clean_text(text, [cleaner])}\n")
            else:
                path, text = entry[0], "|".join(entry[1:])
                f.write(f"{path}|{_clean_text(text, [cleaner])}\n")
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="Pre-phonemize a Matcha filelist (one-time espeak pass)")
    p.add_argument("input", type=str, help="`path|[spk|]text` filelist")
    p.add_argument("output", type=str, help="output filelist with cleaned/phonemized text")
    p.add_argument("--cleaner", type=str, default="english_cleaners2",
                   help="cleaner pipeline to apply once (default english_cleaners2)")
    p.add_argument("--n-spks", type=int, default=1)
    args = p.parse_args(argv)
    n = phonemize_filelist(args.input, args.output, args.cleaner, args.n_spks)
    print(f"[🍵] Phonemized {n} utterances -> {args.output}")
    print("     Train with: data.train_filelist_path=... data.cleaners=[]")
    return n


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
