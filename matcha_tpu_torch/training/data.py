"""Text + mel training data on the host: filelists -> bucketed numpy batches.

The port of ``matcha_tpu/training/data.py``: it parses
``path|text`` (or ``path|spk|text``) filelists, turns text into
blank-interspersed ids with the port's own text frontend, extracts and
normalises log-mels with the port's numpy mel, and pads each batch to the
same bucket grid as the JAX package (``X_BUCKET_GRID``, ``Y_BUCKET_GRID``),
so the two packages give identical batches; a multi-speaker batch carries
``spks`` (B,) int32, each id checked to lie in [0, n_spks) when its item
is read (an id beyond the embedding table would fire a device-side assert
on the card). Mels come out channels-last
(B, T, n_feats). ``num_workers`` threads load items in order (numpy's FFT
releases the interpreter lock).

In a process group (``parallel/dist.py``) each node reads its shard of a
filelist, ``n // n_nodes`` items with the remainder dropped (JAX's
``_process_shard``, a node standing for a JAX process), and forms the
same batches of ``batch_size`` from it as one process would. Each local
rank loads only its contiguous rows of each node batch
(``parallel/mesh.py``: ``n_data_local`` of the node's ranks hold rows, by
JAX's gcd rule; a rank without rows loads the first rank's as a
zero-weight copy) and the batch carries ``rows``: [start, stop, weight]
of those rows in the node batch. The trainer pads them to the shapes of
the whole batch.
"""

import hashlib
import logging
import os
import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from matcha_tpu_torch.audio.mel import resolve_mel_frontend
from matcha_tpu_torch.parallel import dist
from matcha_tpu_torch.parallel.mesh import rank_rows
from matcha_tpu_torch.ops.seq import fix_len_compatibility, normalize, round_up
from matcha_tpu_torch.text import text_to_sequence
from matcha_tpu_torch.utils.utils import intersperse, read_wav

log = logging.getLogger(__name__)

# frame bucket grids: multiples of 4 (U-Net), few distinct shapes
Y_BUCKET_GRID = 64
X_BUCKET_GRID = 16


def parse_filelist(filelist_path, split_char="|") -> List[List[str]]:
    with open(filelist_path, encoding="utf-8") as f:
        return [line.strip().split(split_char) for line in f if line.strip()]


class TextMelDataset:
    """One split of the corpus; items computed on demand, ids cached."""

    def __init__(
        self,
        filelist_path: str,
        n_spks: int,
        cleaners,
        add_blank: bool = True,
        n_fft: int = 1024,
        n_feats: int = 80,
        sample_rate: int = 22050,
        hop_length: int = 256,
        win_length: int = 1024,
        f_min: float = 0.0,
        f_max: float = 8000.0,
        data_statistics: Optional[dict] = None,
        seed: Optional[int] = None,
        phoneme_cache: bool = True,
        mel_cache_dir: Optional[str] = None,
        load_durations: bool = False,
        frontend: str = "numpy",
    ):
        self.filepaths_and_text = parse_filelist(filelist_path)
        self._mel_fn = resolve_mel_frontend(frontend)
        self.load_durations = load_durations
        self.n_spks = n_spks
        self.cleaners = list(cleaners)
        self.add_blank = add_blank
        self.n_fft = n_fft
        self.n_feats = n_feats
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.win_length = win_length
        self.f_min = f_min
        self.f_max = f_max
        stats = data_statistics or {"mel_mean": 0.0, "mel_std": 1.0}
        self.mel_mean = float(stats["mel_mean"])
        self.mel_std = float(stats["mel_std"])
        self.phoneme_cache: Optional[dict] = {} if phoneme_cache else None
        self.mel_cache_dir = mel_cache_dir
        random.Random(seed).shuffle(self.filepaths_and_text)

    def __len__(self) -> int:
        return len(self.filepaths_and_text)

    def get_text(self, text: str) -> np.ndarray:
        if self.phoneme_cache is not None and text in self.phoneme_cache:
            return self.phoneme_cache[text]
        ids = text_to_sequence(text, self.cleaners)
        if self.add_blank:
            ids = intersperse(ids, 0)
        arr = np.asarray(ids, dtype=np.int32)
        if self.phoneme_cache is not None:
            self.phoneme_cache[text] = arr
        return arr

    def get_mel(self, filepath: str) -> np.ndarray:
        """Normalised log-mel (n_feats, T), from the cache when it has it."""
        cache_path = None
        if self.mel_cache_dir:
            digest = hashlib.sha1(filepath.encode()).hexdigest()[:16]
            cache_path = os.path.join(self.mel_cache_dir, f"{digest}.npy")
            if os.path.exists(cache_path):
                return np.load(cache_path)
        audio, sr = read_wav(filepath)
        if sr != self.sample_rate:
            raise ValueError(f"{filepath}: sample rate {sr}, expected {self.sample_rate}")
        mel = self._mel_fn(audio, self.n_fft, self.n_feats, self.sample_rate,
                           self.hop_length, self.win_length, self.f_min, self.f_max)
        mel = normalize(mel, self.mel_mean, self.mel_std)
        if cache_path:
            os.makedirs(self.mel_cache_dir, exist_ok=True)
            # publish atomically: loader threads may race on one item
            tmp = cache_path + f".{os.getpid()}.{id(mel) & 0xFFFF}.tmp.npy"
            np.save(tmp, mel)
            os.replace(tmp, cache_path)
        return mel

    def __getitem__(self, index: int) -> dict:
        entry = self.filepaths_and_text[index]
        if self.n_spks > 1:
            filepath, spk, text = entry[0], int(entry[1]), entry[2]
            if not 0 <= spk < self.n_spks:
                raise ValueError(f"{filepath}: speaker id {spk} outside 0..{self.n_spks - 1}")
        else:
            filepath, text = entry[0], entry[1]
            spk = 0
        item = {"x": self.get_text(text), "y": self.get_mel(filepath), "spk": spk,
                "filepath": filepath, "text": text}
        if self.load_durations:
            item["durations"] = self.get_durations(filepath, item["x"])
        return item

    def get_durations(self, filepath: str, x: np.ndarray) -> np.ndarray:
        """Per-token frame counts from ``<wav_dir>/durations/<stem>.npy``,
        for training on given alignments instead of MAS."""
        stem = os.path.splitext(os.path.basename(filepath))[0]
        dur_path = os.path.join(os.path.dirname(filepath), "durations", f"{stem}.npy")
        durs = np.load(dur_path).astype(np.float32).reshape(-1)
        if durs.shape[0] != x.shape[-1]:
            raise ValueError(f"{dur_path}: {durs.shape[0]} durations != {x.shape[-1]} ids "
                             "(durations count the interspersed id sequence)")
        return durs


def collate_batch(items: List[dict], n_feats: int, n_spks: int,
                  bucket: bool = True) -> Dict[str, np.ndarray]:
    """Zero-pad a list of items into bucket shapes (channels-last y)."""
    B = len(items)
    x_max = max(it["x"].shape[-1] for it in items)
    y_max = fix_len_compatibility(max(it["y"].shape[-1] for it in items))
    if bucket:
        x_max = round_up(x_max, X_BUCKET_GRID)
        y_max = round_up(y_max, Y_BUCKET_GRID)

    x = np.zeros((B, x_max), dtype=np.int32)
    y = np.zeros((B, y_max, n_feats), dtype=np.float32)
    x_lengths = np.zeros((B,), dtype=np.int32)
    y_lengths = np.zeros((B,), dtype=np.int32)
    spks = np.zeros((B,), dtype=np.int32)
    for i, it in enumerate(items):
        xl, yl = it["x"].shape[-1], it["y"].shape[-1]
        x[i, :xl] = it["x"]
        y[i, :yl] = it["y"].T
        x_lengths[i] = xl
        y_lengths[i] = yl
        spks[i] = it["spk"]
    batch = {"x": x, "x_lengths": x_lengths, "y": y, "y_lengths": y_lengths,
             "spks": spks if n_spks > 1 else None}
    if "durations" in items[0]:
        durations = np.zeros((B, x_max), dtype=np.float32)
        for i, it in enumerate(items):
            durations[i, : it["durations"].shape[0]] = it["durations"]
        batch["durations"] = durations
    return batch


class TextMelDataModule:
    """Config-driven train / validation batches (``configs/data/*.yaml``)."""

    def __init__(
        self,
        name: str,
        train_filelist_path: str,
        valid_filelist_path: str,
        batch_size: int,
        num_workers: int = 0,
        pin_memory: bool = True,
        cleaners=("english_cleaners2",),
        add_blank: bool = True,
        n_spks: int = 1,
        n_fft: int = 1024,
        n_feats: int = 80,
        sample_rate: int = 22050,
        hop_length: int = 256,
        win_length: int = 1024,
        f_min: float = 0.0,
        f_max: float = 8000.0,
        data_statistics: Optional[dict] = None,
        seed: Optional[int] = 1234,
        load_durations: bool = False,
        phoneme_cache: bool = True,
        mel_cache_dir: Optional[str] = None,
        frontend: str = "numpy",
        **_unused,
    ):
        self.name = name
        self.batch_size = batch_size
        self.n_feats = n_feats
        self.n_spks = n_spks
        self.seed = seed or 0
        self.num_workers = int(num_workers or 0)
        common = dict(
            n_spks=n_spks, cleaners=cleaners, add_blank=add_blank, n_fft=n_fft,
            n_feats=n_feats, sample_rate=sample_rate, hop_length=hop_length,
            win_length=win_length, f_min=f_min, f_max=f_max,
            data_statistics=data_statistics, seed=seed,
            phoneme_cache=phoneme_cache, mel_cache_dir=mel_cache_dir,
            load_durations=load_durations, frontend=frontend,
        )
        self._train_args = (train_filelist_path, common)
        self._valid_args = (valid_filelist_path, common)
        self.trainset: Optional[TextMelDataset] = None
        self.validset: Optional[TextMelDataset] = None

    def setup(self) -> None:
        if self.trainset is None:
            self.trainset = TextMelDataset(self._train_args[0], **self._train_args[1])
            self.validset = TextMelDataset(self._valid_args[0], **self._valid_args[1])

    @staticmethod
    def _process_shard(n: int) -> range:
        """The items of this node: ``n // n_nodes`` of them, the remainder
        dropped, so that every node runs the same number of steps (each
        step is a collective)."""
        per = n // dist.n_nodes()
        return range(dist.node_rank() * per, (dist.node_rank() + 1) * per)

    def train_batches(self, epoch: int = 0, limit: Optional[float] = None) -> Iterator[dict]:
        """One epoch of training batches of this node's shard, shuffled by
        ``seed + epoch``. ``limit``: a fraction (< 1) or a count of items."""
        self.setup()
        idx = list(self._process_shard(len(self.trainset)))
        random.Random(self.seed + epoch).shuffle(idx)
        yield from self._iterate(self.trainset, _limited(idx, limit))

    def val_batches(self, limit: Optional[float] = None) -> Iterator[dict]:
        self.setup()
        idx = list(self._process_shard(len(self.validset)))
        yield from self._iterate(self.validset, _limited(idx, limit))

    def _load_items(self, ds: TextMelDataset, idx: List[int]) -> Iterator[dict]:
        """Items of ``ds`` at ``idx``, in order, whatever the worker count.
        With workers, a sliding window of futures keeps the pool busy
        across batch boundaries and bounds the items in flight."""
        if self.num_workers <= 0:
            for j in idx:
                yield ds[j]
            return
        window = max(self.batch_size, self.num_workers * 2)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: deque = deque()
            it = iter(idx)
            for j in it:
                pending.append(pool.submit(ds.__getitem__, j))
                if len(pending) >= window:
                    break
            while pending:
                done = pending.popleft()
                for j in it:
                    pending.append(pool.submit(ds.__getitem__, j))
                    break
                yield done.result()

    def _iterate(self, ds: TextMelDataset, idx: List[int]) -> Iterator[dict]:
        n_full = (len(idx) // self.batch_size) * self.batch_size
        take = n_full if n_full else len(idx)  # a tiny split: one short batch
        if not take:
            return
        B = min(self.batch_size, take)
        # this rank's rows of each batch: all of them without a process group
        start, stop, weight = rank_rows(B, dist.local_rank(), dist.local_world_size(),
                                        self.batch_size)
        items = self._load_items(ds, [idx[b + j] for b in range(0, take, B)
                                      for j in range(start, stop)])
        for _ in range(take // B):
            batch = collate_batch([next(items) for _ in range(stop - start)], self.n_feats,
                                  self.n_spks)
            if dist.is_initialized():
                batch["rows"] = np.asarray([start, stop, weight], np.int64)
            yield batch


def _limited(idx: List[int], limit: Optional[float]) -> List[int]:
    if limit is None:
        return idx
    return idx[: max(1, int(len(idx) * limit) if limit < 1 else int(limit))]
