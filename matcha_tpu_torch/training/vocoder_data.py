"""The vocoder-training dataset: random waveform segments and their mels.

The port's own copy of ``matcha_tpu/training/vocoder_data.py``
(``MelDataset``): random ``segment_size``-sample segments drawn from
``random.Random(seed)`` (shorter clips are zero-padded), their log-mel for
the generator's input and, at ``fmax_loss``, for the mel loss; with
``fine_tuning`` the input mel is read from ``base_mels_path/<stem>.npy``
(mels synthesised by an acoustic model) while the audio and the loss mel
stay ground truth. Python's ``random`` is the same in both packages, so
with the same seed the segments are the JAX package's, sample for
sample. ``batches`` yields channels-first torch tensors: ``mel`` and
``mel_loss`` (B, num_mels, frames), ``audio`` (B, 1, segment_size).
"""

import os
import random
from typing import Iterator, List, Optional

import numpy as np
import torch

from matcha_tpu_torch.audio.mel import mel_spectrogram_np
from matcha_tpu_torch.training.data import parse_filelist
from matcha_tpu_torch.utils.utils import read_wav


class MelDataset:
    """Random fixed-length waveform segments + mel targets."""

    def __init__(
        self,
        filelist_path: str,
        segment_size: int = 8192,
        n_fft: int = 1024,
        num_mels: int = 80,
        hop_size: int = 256,
        win_size: int = 1024,
        sampling_rate: int = 22050,
        fmin: float = 0.0,
        fmax: float = 8000.0,
        fmax_loss: Optional[float] = None,
        split: bool = True,
        shuffle: bool = True,
        seed: int = 1234,
        fine_tuning: bool = False,
        base_mels_path: Optional[str] = None,
    ):
        self.audio_files = [e[0] for e in parse_filelist(filelist_path)]
        if shuffle:
            random.Random(seed).shuffle(self.audio_files)
        self.segment_size = segment_size
        self.n_fft = n_fft
        self.num_mels = num_mels
        self.hop_size = hop_size
        self.win_size = win_size
        self.sampling_rate = sampling_rate
        self.fmin = fmin
        self.fmax = fmax
        self.fmax_loss = fmax_loss if fmax_loss is not None else fmax
        self.split = split
        self.fine_tuning = fine_tuning
        self.base_mels_path = base_mels_path
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.audio_files)

    def _mel(self, audio: np.ndarray, fmax: float) -> np.ndarray:
        return mel_spectrogram_np(audio, self.n_fft, self.num_mels, self.sampling_rate,
                                  self.hop_size, self.win_size, self.fmin, fmax)

    def __getitem__(self, index: int) -> dict:
        """{"mel" (num_mels, frames), "audio" (segment_size,), "mel_loss"
        (num_mels, frames)}, numpy."""
        path = self.audio_files[index]
        audio, sr = read_wav(path)
        if sr != self.sampling_rate:
            raise ValueError(f"{path}: {sr} Hz, the config says {self.sampling_rate}")

        if self.fine_tuning:
            stem = os.path.splitext(os.path.basename(path))[0]
            mel = np.load(os.path.join(self.base_mels_path, stem + ".npy"))
            if mel.ndim == 3:
                mel = mel[0]
            if self.split:
                frames_per_seg = -(-self.segment_size // self.hop_size)
                # the start is bounded by the mel and by the audio (a
                # synthesised mel can be a few frames longer than the wav)
                max_start = min(mel.shape[1] - frames_per_seg - 1,
                                audio.shape[0] // self.hop_size - frames_per_seg)
                if audio.shape[0] >= self.segment_size and max_start > 0:
                    mel_start = self._rng.randint(0, max_start)
                    mel = mel[:, mel_start:mel_start + frames_per_seg]
                    audio = audio[mel_start * self.hop_size:
                                  (mel_start + frames_per_seg) * self.hop_size]
                else:
                    mel = np.pad(mel, ((0, 0), (0, max(0, frames_per_seg - mel.shape[1]))))
                    audio = np.pad(audio, (0, max(0, self.segment_size - audio.shape[0])))
                    mel = mel[:, :frames_per_seg]
                    audio = audio[:self.segment_size]
        else:
            if self.split:
                if audio.shape[0] >= self.segment_size:
                    start = self._rng.randint(0, audio.shape[0] - self.segment_size)
                    audio = audio[start:start + self.segment_size]
                else:
                    audio = np.pad(audio, (0, self.segment_size - audio.shape[0]))
            mel = self._mel(audio, self.fmax)
        return {"mel": mel, "audio": audio, "mel_loss": self._mel(audio, self.fmax_loss)}

    def batches(self, batch_size: int, epoch: int = 0) -> Iterator[dict]:
        """Batches in an order shuffled by ``random.Random(epoch)``; the
        remainder is dropped."""
        idx = list(range(len(self)))
        random.Random(epoch).shuffle(idx)
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            items: List[dict] = [self[j] for j in idx[i:i + batch_size]]
            yield {
                "mel": torch.from_numpy(np.stack([it["mel"] for it in items])),
                "mel_loss": torch.from_numpy(np.stack([it["mel_loss"] for it in items])),
                "audio": torch.from_numpy(np.stack([it["audio"] for it in items])[:, None]),
            }
