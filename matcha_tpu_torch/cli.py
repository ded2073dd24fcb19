"""Text -> wav with the PyTorch port: the synthesis pipeline and its CLI.

Port of ``matcha_tpu/cli.py``'s three synthesis paths:
- the dynamic path: encode -> host pick of the mel bucket -> decode ->
  slice to the finer vocoder bucket -> vocode (the fused-MRF generator)
  -> clip -> denoise -> optional 24-bit PCM packing;
- the fixed-bucket path (``fixed_y_bucket``, CLI ``--fixed-y-bucket``):
  the whole text -> wav body at one mel bucket, one CUDA graph per
  bucket on a GPU (``fused.py``), with the self-calibrating ``"auto"``
  bucket, its saturation escalation and the top-bucket fallback to the
  dynamic path;
- staged corpus synthesis (``synthesise_corpus``, CLI ``--batched
  --staged``): every batch's encoder pass of a window first, one host
  copy of their predicted lengths, then decode + vocode per batch with no
  other host sync, split or (``--fused-stage``) as one CUDA graph per
  bucket triple.
With ``vocoder_chunk`` (``--vocoder-chunk N``) every path vocodes in
N-frame mel windows with a halo. Precision, as in JAX: ``vocoder_bf16``
(``--bf16-vocoder``) runs every path's vocoder on a bf16 copy of the
generator; ``bf16_latency`` (``--bf16-latency``) runs the fixed-bucket
body's Euler loop on a bf16 copy of the decoder and its vocoder in bf16;
``vocoder_pallas=False`` (``--no-pallas-vocoder``) runs the generator
all on cuDNN, no fused MRF kernel; ``--full-precision`` turns TF32 off.
Data-parallel serving (``TTSPipeline(devices=)``, CLI ``--data-parallel``):
one replica of the models per device; a batch whose size divides by the
replica count is split into contiguous rows, one part per replica (JAX's
``data`` axis), and the results are gathered on the first device in input
order. The noise is drawn at the whole batch's shape on the first device
and each replica gets its rows, so the output equals one device's.
A multi-speaker model (the VCTK Matcha) takes a speaker id on every
path (``spks``, CLI ``--spk``), checked on the host against the model's
``n_spks`` before it reaches the card. The CLI synthesises one utterance
at a time, in length-sorted batches (``--batched``, ``--staged``) or
sentence by sentence (``--long-form``). ``--batched --staged`` prints
the corpus's frame fill (``corpus_frames_true`` over
``corpus_frames_decoded``: the share of the decoded mel frames that are
speech, not bucket padding); ``--trace-spans PATH`` records the
pipeline's spans (``utils/tracing.py``) and writes them as a Chrome trace.
Models are named as in JAX's registry (``--model matcha_ljspeech |
matcha_vctk``, ``--vocoder hifigan_T2_v1 | hifigan_univ_v1``, with each
model's default vocoder, speaking rate and speaker: ``validate_args``) and
read from ``$MATCHA_HOME/matcha_tpu/<name>[.ckpt]``; nothing is
downloaded (the published URLs are named when a file is missing).
``--checkpoint_path`` takes a reference Lightning ``.ckpt`` or the port's
own native checkpoint (``checkpoint_<step>`` or ``last`` with its
``.hparams.json`` beside it); a vocoder file is ``{"generator":
state_dict}``. Every path writes ``<name>.wav``, ``.npy`` and ``.png``.

    python -m matcha_tpu_torch.cli --text "..." --cleaner english_cleaners_no_espeak
"""

import argparse
import collections
import contextlib
import copy
import os
import sys
import time
import warnings
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from matcha_tpu_torch import resolve_device
from matcha_tpu_torch.convert import fold_hifigan_state_dict
from matcha_tpu_torch.fused import FusedGraph, StageGraph, _pack_pcm24
from matcha_tpu_torch.models.denoiser import compute_bias_spec, denoise
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.hifigan_fused import (
    MAX_FUSED_CHANNELS,
    fused_stage_weights,
    generator_apply_fused,
)
from matcha_tpu_torch.models.matcha import MatchaTTS, check_speakers, decoder_cast
from matcha_tpu_torch.parallel.mesh import replica_rows
from matcha_tpu_torch.text import intersperse, sequence_to_text, text_to_sequence
from matcha_tpu_torch.text.segment import split_sentences
from matcha_tpu_torch.utils import tracing
from matcha_tpu_torch.utils.checkpoints import load_native_checkpoint
from matcha_tpu_torch.utils.utils import PCM24_SCALE, save_plot, write_wav

MATCHA_URLS = {
    "matcha_ljspeech": "https://github.com/shivammehta25/Matcha-TTS-checkpoints/releases/download/v1.0/matcha_ljspeech.ckpt",
    "matcha_vctk": "https://github.com/shivammehta25/Matcha-TTS-checkpoints/releases/download/v1.0/matcha_vctk.ckpt",
}

VOCODER_URLS = {
    "hifigan_T2_v1": "https://github.com/shivammehta25/Matcha-TTS-checkpoints/releases/download/v1.0/generator_v1",
    "hifigan_univ_v1": "https://github.com/shivammehta25/Matcha-TTS-checkpoints/releases/download/v1.0/g_02500000",
}

MULTISPEAKER_MODEL = {
    "matcha_vctk": {"vocoder": "hifigan_univ_v1", "speaking_rate": 0.85, "spk": 0, "spk_range": (0, 107)}
}

SINGLESPEAKER_MODEL = {"matcha_ljspeech": {"vocoder": "hifigan_T2_v1", "speaking_rate": 0.95, "spk": None}}

X_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)
Y_BUCKETS = (128, 256, 384, 512, 768, 1024, 1536, 2048)
# The vocoder runs on a finer 128-frame grid: the decode bucket's padding
# tail is sliced off before the most expensive stage.
VOC_BUCKETS = tuple(range(128, 2049, 128))
HOP = 256
SAMPLE_RATE = 22050


def pick_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 63) // 64) * 64  # beyond the table: round to 64


def _unpack_pcm24(arr: np.ndarray):
    """Host inverse of ``_pack_pcm24``: (B, 3n+3) uint8 -> f32 waveform
    (B, n) + int32 mel_lengths (B,)."""
    u = arr.reshape(arr.shape[0], -1, 3).astype(np.int32)
    v = u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)
    v = (v ^ 0x800000) - 0x800000  # sign-extend 24 -> 32 bit
    wav = (v[:, :-1] / np.float32(PCM24_SCALE)).astype(np.float32)
    return wav, v[:, -1].astype(np.int32)


def _pcm24_lengths(arr: np.ndarray) -> np.ndarray:
    """mel_lengths from packed PCM24 rows without decoding the audio: only
    the trailing 3-byte sample of each row is read (lengths are positive
    and below 2^23). The other bytes of a row are the WAV frames as
    ``write_wav`` writes them."""
    t = arr[:, -3:].astype(np.int32)
    return t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16)


def fetch_fused_host(out: dict):
    """A fixed-bucket result's (waveform, mel_lengths) on the host, in one
    copy, whichever wire format the graph packed (``wav_pcm24``,
    ``wav_packed``, or the plain f32 waveform and lengths). The ``"auto"``
    path has already fetched into ``*_host`` keys for its saturation
    check; integer-bucket callers use this."""
    if "waveform_host" in out:
        return out["waveform_host"], np.asarray(out["mel_lengths_host"])
    if "pcm24_bytes_host" in out:  # raw_pcm24 delivery, already fetched
        return _unpack_pcm24(out["pcm24_bytes_host"])
    if "wav_pcm24" in out:
        return _unpack_pcm24(out["wav_pcm24"].cpu().numpy())
    if "wav_packed" in out:
        packed = out["wav_packed"].cpu().numpy()
        return packed[:, :-1], packed[:, -1].astype(np.int32)
    return out["waveform"].cpu().numpy(), out["mel_lengths"].cpu().numpy()


def _fetch_auto_host(out: dict, raw_pcm24: bool) -> np.ndarray:
    """The ``"auto"`` path's one host copy of a result, kept in the keys
    that ``fetch_fused_host`` reads back: the packed rows as
    ``pcm24_bytes_host`` (``raw_pcm24`` delivery, lengths read from the
    last sample), else the waveform of either wire format as
    ``waveform_host``; a result with neither (no vocoder, or the dynamic
    fallback's f32 waveform) fetches its lengths only. Sets and returns
    ``mel_lengths_host``."""
    if raw_pcm24 and "wav_pcm24" in out:
        out["pcm24_bytes_host"] = out["wav_pcm24"].cpu().numpy()
        ml = _pcm24_lengths(out["pcm24_bytes_host"])
    elif "wav_pcm24" in out or "wav_packed" in out:
        out["waveform_host"], ml = fetch_fused_host(out)
    else:
        ml = out["mel_lengths"].cpu().numpy()
    out["mel_lengths_host"] = ml
    return ml


def synth_fetch_guarded(pipeline, x, x_lengths, *, fixed_y_bucket=0, **kw):
    """``synthesise_batch`` + host fetch, with the integer fixed-bucket
    saturation guard. An int ``fixed_y_bucket`` replays with no host sync,
    so nothing inside the pipeline can check for clipping: the fetched
    lengths are checked here and, on saturation, this warns and runs the
    length-general dynamic path instead. ``"auto"`` escalates inside
    ``synthesise_batch`` (with its own top-bucket fallback), so it passes
    straight through. Returns ``(out, waveforms, mel_lengths)``, the last
    two on the host."""
    out = pipeline.synthesise_batch(x, x_lengths, fixed_y_bucket=fixed_y_bucket, **kw)
    wavs, mls = fetch_fused_host(out)
    if (fixed_y_bucket and fixed_y_bucket != "auto"
            and int(np.max(mls)) >= int(fixed_y_bucket)):
        warnings.warn(
            f"[-] --fixed-y-bucket {fixed_y_bucket} saturated (predicted mel "
            f"length >= bucket); re-running through the dynamic path so the "
            f"written audio is full-length. Pick a larger bucket, 'auto', "
            f"or --long-form to avoid the retry.", UserWarning)
        out = pipeline.synthesise_batch(x, x_lengths, **kw)
        wavs, mls = fetch_fused_host(out)
    return out, wavs, mls


def process_text(i: int, text: str, cleaner: str = "english_cleaners2"):
    print(f"[{i}] - Input text: {text}")
    seq = intersperse(text_to_sequence(text, [cleaner]), 0)
    x = np.asarray(seq, dtype=np.int32)[None]
    x_lengths = np.asarray([x.shape[-1]], dtype=np.int32)
    x_phones = sequence_to_text(list(x[0]))
    print(f"[{i}] - Phonetised text: {x_phones[1::2]}")
    return {"x_orig": text, "x": x, "x_lengths": x_lengths, "x_phones": x_phones}


#: unit noise for a call: a (B, T_y, n_feats) tensor at the bucket the call
#: uses, or a callable T_y -> such a tensor (the bucket of an "auto" call is
#: not known in advance)
Noise = Union[torch.Tensor, Callable[[int], torch.Tensor], None]
#: unit noise for a corpus: batch index, B, T_y -> a (B, T_y, n_feats) tensor
CorpusNoise = Optional[Callable[[int, int, int], torch.Tensor]]


class TTSPipeline:
    """Bucketed synthesis: MatchaTTS + fused-MRF HiFi-GAN + denoiser, on
    the dynamic path or as one CUDA graph per fixed mel bucket.

    ``devices``: a list of devices, one replica each (``replicas``; the
    pipeline itself is the first, on ``devices[0]``, and each other is a
    single-device ``TTSPipeline`` over deep copies of the models). Every
    path splits a batch of B rows over the n replicas when n divides B;
    otherwise, by rule, the whole batch runs on the first replica (JAX
    replicates such a batch: the result is the same). Each part runs the
    whole batch's buckets (T_x, the mel bucket, the vocoder bucket) on its
    own device, the fixed-bucket and staged bodies as one graph per
    (device, shape) over its rows. A list of one device is ``device=``.
    Nothing falls back: a replica that fails to build or launch raises."""

    #: candidate mel buckets of the fixed-bucket path under "auto" (finer
    #: than Y_BUCKETS: the tightest bucket is the least decode and vocoder
    #: work)
    FUSED_Y_BUCKETS = tuple(range(64, 2049, 64))
    #: headroom over the calibrated frames-per-token estimate
    FUSED_MARGIN = 1.15
    #: mel frames of halo on each side of a chunked vocoder window: the
    #: generator's receptive field is ~17 frames (conv_pre, the MRF stages
    #: at each upsample rate, conv_post), so 32 leaves twice that
    VOC_CHUNK_HALO = 32

    def __init__(self, model: MatchaTTS, vocoder: Optional[Generator] = None,
                 denoiser_bias: Optional[torch.Tensor] = None,
                 cleaner: str = "english_cleaners2", device=None,
                 denoiser_strength: float = 0.00025, pcm24_transfer: bool = True,
                 vocoder_chunk: int = 0, vocoder_bf16: bool = False,
                 vocoder_pallas: bool = True, bf16_latency: bool = False, devices=None):
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            if not devices:
                raise ValueError("devices=[]: give at least one device")
            if device is not None and _indexed(resolve_device(device)) != _indexed(devices[0]):
                raise ValueError(f"device={device} is not devices[0]={devices[0]}")
            device = devices[0]
        self.device = resolve_device(device)
        # the other replicas, each a single-device pipeline (set before the
        # properties below, which reach them)
        self._children = []
        self.model = model.to(self.device).eval()
        # the fused MRF kernel on the narrow stages, or (False) every stage
        # on cuDNN, on every path
        self.vocoder_pallas = vocoder_pallas
        self.max_fused_channels = MAX_FUSED_CHANNELS if vocoder_pallas else 0
        # bf16 vocoder weights and activations (a copy; the caller's
        # generator is left as it is)
        self.vocoder_bf16 = vocoder_bf16
        vocoder = None if vocoder is None else vocoder.to(self.device).eval()
        self._vocoders = {}
        if vocoder is not None:
            self._vocoders[False] = self._packed(vocoder)
            if vocoder_bf16 or bf16_latency:
                self._vocoders[True] = self._packed(
                    copy.deepcopy(vocoder).to(torch.bfloat16).eval())
        self.vocoder = None if vocoder is None else self._vocoders[vocoder_bf16][0]
        # the fused stages' kernel weights, packed once here and not per call
        self.vocoder_weights = None if vocoder is None else self._vocoders[vocoder_bf16][1]
        # the fixed-bucket body's Euler loop on a bf16 copy of the decoder
        # and its vocoder in bf16; the encoder, the durations and every
        # other path stay f32
        self.bf16_latency = bf16_latency
        self.latency_model = decoder_cast(self.model, torch.bfloat16) if bf16_latency else None
        # the denoiser's bias spectrum stays the f32 generator's
        self.denoiser_bias = None if denoiser_bias is None else denoiser_bias.to(self.device)
        self.cleaner = cleaner
        self._denoiser_strength = denoiser_strength
        # the fixed-bucket path's wire format: 24-bit PCM with the lengths as
        # a last sample (the written-WAV encoding, 3 bytes a sample), else
        # the f32 rows with the lengths as a last column
        self.pcm24_transfer = pcm24_transfer
        # the vocoder over N-frame mel windows with a halo, one window after
        # another, so that its activations are one window's (0 = off)
        self.vocoder_chunk = int(vocoder_chunk)
        self._graphs = {}
        self._graph_pool = None
        # False refuses any new CUDA graph capture (the serving daemon after
        # its warmup: a capture while its other threads launch work breaks)
        self._capture_allowed = True
        # "auto" calibration: the p90 of the recent mel frames per (id x
        # length_scale); None until a call returns real mel lengths
        self._dur_ratio = None
        self._dur_obs = collections.deque(maxlen=64)
        #: ``synthesise_corpus``'s true mel frames (the host lengths, clipped
        #: to the bucket) and the frames it decoded for them (B x T_y a batch)
        self.corpus_frames_true = 0
        self.corpus_frames_decoded = 0
        for d in (devices or [])[1:]:
            self._children.append(TTSPipeline(
                copy.deepcopy(self.model), None if vocoder is None else copy.deepcopy(vocoder),
                self.denoiser_bias, cleaner, device=d, denoiser_strength=denoiser_strength,
                pcm24_transfer=pcm24_transfer, vocoder_chunk=vocoder_chunk,
                vocoder_bf16=vocoder_bf16, vocoder_pallas=vocoder_pallas,
                bf16_latency=bf16_latency))

    @property
    def replicas(self) -> list:
        """The pipelines that hold the models, one per device; this one
        first."""
        return [self] + self._children

    @property
    def denoiser_strength(self) -> float:
        return self._denoiser_strength

    @denoiser_strength.setter
    def denoiser_strength(self, value: float) -> None:
        for r in self.replicas:
            r._denoiser_strength = value

    @property
    def capture_allowed(self) -> bool:
        return self._capture_allowed

    @capture_allowed.setter
    def capture_allowed(self, value: bool) -> None:
        for r in self.replicas:
            r._capture_allowed = value

    def _parts(self, B: int) -> list:
        """[(replica, rows)] of a batch of B: contiguous rows per replica
        when B divides by their count, else the whole batch on the first."""
        rows = replica_rows(B, len(self.replicas)) if self._children else None
        if rows is None:
            return [(self, slice(0, B))]
        return list(zip(self.replicas, rows))

    def _noise_parts(self, z, shape: tuple, generator: Optional[torch.Generator], parts: list,
                     graph: bool = False) -> list:
        """Each part's unit noise: ``z`` itself for one part (None: drawn
        where it is used, as on one device); for several, the rows of ``z``
        or of one draw at the whole batch's (B, T_y, n_feats) on the first
        device from ``generator`` (``normal_`` into a buffer as a graph
        stages it, else ``randn`` as ``decode`` draws it: the same values
        one device would draw)."""
        if len(parts) == 1:
            return [z]
        if z is None:
            shape = shape + (self.model.n_feats,)
            z = (torch.empty(shape, device=self.device).normal_(generator=generator) if graph
                 else torch.randn(shape, generator=generator, device=self.device))
        return [z[rows].to(rep.device) for rep, rows in parts]

    def _gather(self, outs: list) -> dict:
        """The parts' outputs as one batch on the first device, in input
        order (0-d values from the first part)."""
        if len(outs) == 1:
            return outs[0]
        return {k: (torch.cat([o[k].to(self.device) for o in outs]) if outs[0][k].dim()
                    else outs[0][k]) for k in outs[0]}

    def _packed(self, vocoder: Generator) -> tuple:
        """(generator, its fused stages' packed weights under this
        pipeline's cap)."""
        return vocoder, fused_stage_weights(vocoder, self.max_fused_channels)

    def _generate(self, mel_btc: torch.Tensor, bf16: Optional[bool] = None) -> torch.Tensor:
        """Mel (B, T, n_feats) f32 -> the generator's output (B, T * hop, 1)
        in f32; with ``bf16`` (None = ``vocoder_bf16``) on the bf16
        generator, the mel cast to bf16 and each output cast back. With
        ``vocoder_chunk``, window by window: each window of N frames runs
        with ``VOC_CHUNK_HALO`` frames of the mel on either side (fewer at
        the edges, where the generator's own zero padding applies), and
        only its centre is kept."""
        bf16 = self.vocoder_bf16 if bf16 is None else bf16
        if bf16 not in self._vocoders:
            raise ValueError("a bf16 vocoder call on a pipeline built without vocoder_bf16 or "
                             "bf16_latency")
        gen, weights = self._vocoders[bf16]
        mel = mel_btc.to(torch.bfloat16) if bf16 else mel_btc

        def run(m):
            out = generator_apply_fused(gen, m, weights, max_fused_channels=self.max_fused_channels)
            return out.float() if bf16 else out

        chunk, halo = self.vocoder_chunk, self.VOC_CHUNK_HALO
        T = mel.shape[1]
        if not chunk or T <= chunk + halo:
            return run(mel)
        outs = []
        for s in range(0, T, chunk):
            e = min(s + chunk, T)
            s0, e0 = max(0, s - halo), min(T, e + halo)
            outs.append(run(mel[:, s0:e0])[:, (s - s0) * HOP:(e - s0) * HOP])
        return torch.cat(outs, dim=1)

    def vocode(self, mel_btc: torch.Tensor, bf16: Optional[bool] = None) -> torch.Tensor:
        """Mel (B, T, n_feats) -> clipped, denoised waveform (B, T * hop),
        f32. ``bf16``: the generator in bf16 (None = ``vocoder_bf16``); the
        clip and the denoiser run in f32 on its output either way. Spans
        ``models.vocode`` (the generator and the clip) and ``models.denoise``,
        except while a CUDA graph captures the call."""
        with _eager_span("models.vocode", mel_btc):
            wav = torch.clamp(self._generate(mel_btc, bf16)[..., 0], -1.0, 1.0)
        if self.denoiser_bias is None:
            return wav
        with _eager_span("models.denoise", wav):
            return denoise(wav, self.denoiser_bias, strength=self.denoiser_strength)

    def fused_graph(self, B: int, T_x: int, T_y: int, n_timesteps: int, temperature: float,
                    length_scale: float, cuda_graph: Optional[bool] = None,
                    has_spk: bool = False) -> FusedGraph:
        """The cached fixed-bucket body for this key (``_fused_fn``'s key
        fields, ``has_spk`` among them, plus B, the wire format and the
        graph mode; the port has no key fold)."""
        key = (B, T_x, T_y, n_timesteps, temperature, length_scale, has_spk,
               float(self.denoiser_strength), self.pcm24_transfer, cuda_graph)
        if key not in self._graphs:
            self._graphs[key] = FusedGraph(self, B, T_x, T_y, n_timesteps, temperature,
                                           length_scale, self.pcm24_transfer, has_spk,
                                           cuda_graph, self._pool(cuda_graph))
        return self._graphs[key]

    def stage_graph(self, B: int, T_x: int, T_y: int, T_voc: int, n_timesteps: int,
                    temperature: float, cuda_graph: Optional[bool] = None,
                    has_spk: bool = False) -> StageGraph:
        """The cached decode + vocode stage for this key (``_decode_vocode_fn``'s
        key fields plus B, ``has_spk``, the denoiser strength and the graph
        mode)."""
        key = ("stage", B, T_x, T_y, T_voc, n_timesteps, temperature, has_spk,
               float(self.denoiser_strength), cuda_graph)
        if key not in self._graphs:
            self._graphs[key] = StageGraph(self, B, T_x, T_y, T_voc, n_timesteps, temperature,
                                           has_spk, cuda_graph, self._pool(cuda_graph))
        return self._graphs[key]

    def _pool(self, cuda_graph: Optional[bool]):
        """The memory pool all of the pipeline's graphs share."""
        if self._graph_pool is None and self.device.type == "cuda" and cuda_graph is not False:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def observe_dur_ratio(self, obs: float) -> None:
        """Fold one non-saturated fixed-bucket result into the
        frames-per-token calibration of ``_auto_y_bucket``: the 90th
        percentile of the last 64 observations, not an all-time maximum,
        so that one long-winded utterance does not push every later
        request onto a larger bucket for good. An underestimate costs the
        one call a re-run at a larger bucket; an overestimate taxes every
        call."""
        self._dur_obs.append(float(obs))
        self._dur_ratio = float(np.quantile(np.asarray(self._dur_obs), 0.9))

    def _auto_y_bucket(self, n_ids: int, length_scale: float) -> int:
        """The tightest fixed mel bucket from the calibrated ratio; the
        largest before any calibration (always right, just not tight)."""
        if self._dur_ratio is None:
            return self.FUSED_Y_BUCKETS[-1]
        est = n_ids * length_scale * self._dur_ratio * self.FUSED_MARGIN
        for b in self.FUSED_Y_BUCKETS:
            if b >= est:
                return b
        return self.FUSED_Y_BUCKETS[-1]

    @torch.inference_mode()
    def synthesise_batch(self, x: np.ndarray, x_lengths: np.ndarray, n_timesteps: int = 10,
                         temperature: float = 0.667, length_scale: float = 1.0,
                         z: Noise = None, generator: Optional[torch.Generator] = None,
                         pack_wav: bool = False, fixed_y_bucket: Union[int, str] = 0,
                         raw_pcm24: bool = False, cuda_graph: Optional[bool] = None,
                         spks=None) -> dict:
        """ids (B, T) + lengths -> the ``decode`` dict plus the waveform.

        ``spks``: host speaker ids (B,) for a multi-speaker model (checked
        against its ``n_spks``: ValueError before anything runs), ignored
        by a single-speaker one.

        Noise: ``z``, unit normal (B, T_y, n_feats) at the mel bucket T_y
        the call uses, or a callable ``z(T_y)`` that returns it; otherwise
        drawn from ``generator``. JAX's ``key_fold`` has no counterpart:
        the noise is always this explicit ``z`` or ``generator``.

        Dynamic path (``fixed_y_bucket`` 0): ``waveform`` (B, T_voc * hop),
        or ``wav_pcm24`` when ``pack_wav``.

        ``fixed_y_bucket`` an int: the whole path at that mel bucket, one
        replay of the bucket's CUDA graph on a GPU (captured at its first
        call), the same body eagerly on the CPU; ``waveform`` (B, T_y *
        hop) plus ``wav_pcm24`` (or ``wav_packed`` without
        ``pcm24_transfer``). No host sync: lengths that reach the bucket
        mean clipped audio, which ``synth_fetch_guarded`` checks.
        ``cuda_graph=False`` runs the body eagerly on the GPU.

        ``"auto"``: the bucket from ``_auto_y_bucket``. One host copy
        carries the wav and the lengths (``waveform_host`` and
        ``mel_lengths_host``); a result that reached its bucket re-runs at
        the first bucket of at least twice the size, and one that reached
        the largest falls back to the dynamic path with a warning. Only
        results that did not saturate calibrate the ratio. ``raw_pcm24``
        (pcm24 wire): deliver the packed rows as ``pcm24_bytes_host``
        instead of the f32 ``waveform_host``, also through the fallback.

        Recorded as a ``pipeline.synthesise_batch`` span (``utils/tracing.py``)
        with B, the path (``fast``: a fixed bucket) and the x, mel and
        vocoder buckets; the dynamic path's ``models.*`` calls and its
        ``pipeline.lengths_sync`` inside it.
        """
        path = "fast" if fixed_y_bucket else "dynamic"
        with tracing.span("pipeline.synthesise_batch", B=len(x), path=path) as span:
            x = np.asarray(x)
            x_lengths_host = np.asarray(x_lengths, dtype=np.int32)
            spk_ids = check_speakers(self.model.n_spks, spks)
            if spk_ids is not None and spk_ids.shape != (x.shape[0],):
                raise ValueError(f"{spk_ids.shape[0]} speaker ids for a batch of {x.shape[0]}")
            T_x = pick_bucket(x.shape[-1], X_BUCKETS)
            x_pad = np.zeros((x.shape[0], T_x), dtype=np.int64)
            x_pad[:, :x.shape[-1]] = x

            if fixed_y_bucket:
                auto = fixed_y_bucket == "auto"
                T_y = (self._auto_y_bucket(int(x_lengths_host.max()), length_scale)
                       if auto else int(fixed_y_bucket))
                parts = self._parts(x.shape[0])
                while True:
                    zs = self._noise_parts(z(T_y) if callable(z) else z, (x.shape[0], T_y), generator,
                                           parts, graph=True)
                    out = self._gather([
                        rep.fused_graph(rows.stop - rows.start, T_x, T_y, n_timesteps, temperature,
                                        length_scale, cuda_graph, spk_ids is not None)(
                            x_pad[rows], x_lengths_host[rows], zr, generator,
                            None if spk_ids is None else spk_ids[rows])
                        for (rep, rows), zr in zip(parts, zs)])
                    if not auto:
                        span.set(T_x=T_x, T_y=T_y, T_voc=T_y)
                        return out
                    ml = _fetch_auto_host(out, raw_pcm24)
                    saturated = bool((ml >= T_y).any())
                    valid = x_lengths_host > 0
                    if not saturated and valid.any():
                        self.observe_dur_ratio(
                            float(np.max(ml[valid] / (x_lengths_host[valid] * length_scale))))
                    if not saturated:
                        span.set(T_x=T_x, T_y=T_y, T_voc=T_y)
                        return out
                    if T_y >= self.FUSED_Y_BUCKETS[-1]:
                        # clipped audio is never acceptable: the dynamic path
                        # is length-general (pick_bucket rounds past its table)
                        warnings.warn(
                            f"[-] Utterance saturated the largest fused mel "
                            f"bucket ({T_y} frames); falling back to the "
                            f"dynamic path for full-length audio. Consider "
                            f"--long-form for very long inputs.", UserWarning)
                        out = self.synthesise_batch(
                            x, x_lengths_host, n_timesteps=n_timesteps, temperature=temperature,
                            length_scale=length_scale, z=z, generator=generator,
                            pack_wav=raw_pcm24, spks=spk_ids)
                        _fetch_auto_host(out, raw_pcm24)  # the same byte-delivery contract
                        return out
                    T_y = next((b for b in self.FUSED_Y_BUCKETS if b >= 2 * T_y),
                               self.FUSED_Y_BUCKETS[-1])

            parts = self._parts(x.shape[0])
            encoded = []
            for rep, rows in parts:
                x_t = torch.from_numpy(x_pad[rows]).to(rep.device)
                xl = torch.from_numpy(x_lengths_host[rows]).to(rep.device)
                spks_t = None if spk_ids is None else torch.from_numpy(spk_ids[rows]).to(rep.device)
                with tracing.span("models.encode"):
                    encoded.append((xl, spks_t, *rep.model.encode(x_t, xl, length_scale, spks_t)))
            # the one host sync of the path (one per replica)
            with tracing.span("pipeline.lengths_sync"):
                max_y = max(int(e[-1].max()) for e in encoded)
            T_y = pick_bucket(max_y, Y_BUCKETS)
            T_voc = min(T_y, pick_bucket(min(max_y, T_y), VOC_BUCKETS))
            span.set(T_x=T_x, T_y=T_y, T_voc=T_voc)
            zs = self._noise_parts(z(T_y) if callable(z) else z, (x.shape[0], T_y), generator, parts)
            outs = []
            for (rep, _), (xl, spks_t, mu_x, w_ceil, y_lengths), zr in zip(parts, encoded, zs):
                with tracing.span("models.decode"):
                    out = rep.model.decode(mu_x, w_ceil, xl, y_lengths, n_timesteps, temperature,
                                           y_max_length=T_y, z=zr, generator=generator,
                                           spks=spks_t)
                if rep.vocoder is not None:
                    wav = rep.vocode(out["mel"].transpose(1, 2)[:, :T_voc])
                    if pack_wav:
                        out["wav_pcm24"] = _pack_pcm24(wav, out["mel_lengths"])
                    else:
                        out["waveform"] = wav
                outs.append(out)
            return self._gather(outs)

    @torch.inference_mode()
    def synthesise_corpus(self, utterances, n_timesteps: int = 10, temperature: float = 0.667,
                          length_scale: float = 1.0, batch_size: int = 8,
                          stage_window: int = 64, fuse_stages: bool = False,
                          z: CorpusNoise = None, generator: Optional[torch.Generator] = None,
                          cuda_graph: Optional[bool] = None, spk: Optional[int] = None):
        """Staged batched synthesis of a whole corpus, as JAX's
        ``synthesise_corpus``: the utterances (1-D id arrays) sorted by
        length and cut into batches of ``batch_size``; per window of
        ``stage_window`` batches,
        1. every batch's encoder pass, launched with nothing blocking (the
           ids reach the card through pinned memory);
        2. ONE host copy of the window's predicted mel lengths;
        3. per batch, the mel bucket and the finer vocoder bucket picked on
           the host, then decode and vocode, or with ``fuse_stages`` one
           call of the stage's body (``fused.py::StageGraph``: a CUDA graph
           per (B, T_x, T_y, T_voc) on a GPU, captured at its first use);
           no other host sync.
        Stage 1 keeps a window's encoder outputs on the card until stage 3
        reaches them, so the window bounds that memory.

        Noise per batch: ``z(batch_index, B, T_y)`` with ``batch_index`` the
        batch's place in the sorted corpus (JAX folds it into its key),
        else drawn from ``generator`` (on the pipeline's device) batch by
        batch. ``cuda_graph=False`` runs the fused stage eagerly on a GPU.
        ``spk``: one speaker id for the whole corpus (a multi-speaker
        model), checked on the host first.

        Yields ``(utterance indices, out)`` per batch in sorted order:
        ``out`` is the ``decode`` dict plus ``waveform`` (B, T_voc * hop)
        (and ``first_sample`` when fused), and ``mel_lengths_host``, the
        lengths already on the host.

        Spans (``utils/tracing.py``): ``pipeline.corpus.encode`` and
        ``pipeline.corpus.lengths`` per window, ``pipeline.corpus.batch`` per
        batch, the ``models.*`` calls inside them on the split path.
        """
        spk_id = check_speakers(self.model.n_spks, None if spk is None else [spk])
        order = sorted(range(len(utterances)), key=lambda i: len(utterances[i]))
        batches = [order[s:s + batch_size] for s in range(0, len(order), batch_size)]
        step = max(1, stage_window)
        for w0 in range(0, len(batches), step):
            window = batches[w0:w0 + step]

            # 1. the window's encoder passes, per replica part; nothing blocks
            encoded = []
            with tracing.span("pipeline.corpus.encode", batches=len(window)):
                for chunk in window:
                    T_x = pick_bucket(max(len(utterances[i]) for i in chunk), X_BUCKETS)
                    x = torch.zeros((len(chunk), T_x), dtype=torch.int64)
                    x_lengths = torch.zeros((len(chunk),), dtype=torch.int32)
                    for row, idx in enumerate(chunk):
                        x[row, :len(utterances[idx])] = torch.as_tensor(np.asarray(utterances[idx]))
                        x_lengths[row] = len(utterances[idx])
                    spks = None if spk_id is None else np.full((len(chunk),), spk_id[0], np.int32)
                    parts = []
                    for rep, rows in self._parts(len(chunk)):
                        xr, xlr = (_to_device(t[rows], rep.device) for t in (x, x_lengths))
                        spks_t = (None if spks is None
                                  else _to_device(torch.from_numpy(spks[rows]), rep.device))
                        with tracing.span("models.encode"):
                            parts.append((rep, rows, xlr, spks_t,
                                          *rep.model.encode(xr, xlr, length_scale, spks_t)))
                    encoded.append((chunk, T_x, spks, parts))

            # 2. one host copy of the window's predicted lengths per replica
            with tracing.span("pipeline.corpus.lengths"):
                y_host = self._lengths_host([e[3] for e in encoded])

            # 3. decode + vocode per batch, the buckets known on the host; the
            # span closes before the yield, so none is open while the caller
            # holds the generator
            fused = self.vocoder is not None and fuse_stages
            for bi, (chunk, T_x, spks, parts) in enumerate(encoded):
                B, max_y = len(chunk), int(y_host[bi].max())
                T_y = pick_bucket(max_y, Y_BUCKETS)
                T_voc = min(T_y, pick_bucket(min(max_y, T_y), VOC_BUCKETS))
                with tracing.span("pipeline.corpus.batch", B=B, T_x=T_x, T_y=T_y, T_voc=T_voc):
                    zs = self._noise_parts(None if z is None else z(w0 + bi, B, T_y), (B, T_y),
                                           generator, [p[:2] for p in parts], graph=fused)
                    outs = []
                    for (rep, rows, xlr, spks_t, mu_x, w_ceil, y_lengths), zr in zip(parts, zs):
                        if fused:
                            stage = rep.stage_graph(rows.stop - rows.start, T_x, T_y, T_voc,
                                                    n_timesteps, temperature, cuda_graph,
                                                    spks is not None)
                            out = stage(mu_x, w_ceil, xlr, y_lengths, zr, generator,
                                        None if spks is None else spks[rows])
                        else:
                            with tracing.span("models.decode"):
                                out = rep.model.decode(mu_x, w_ceil, xlr, y_lengths, n_timesteps,
                                                       temperature, y_max_length=T_y, z=zr,
                                                       generator=generator, spks=spks_t)
                            if rep.vocoder is not None:
                                out["waveform"] = rep.vocode(out["mel"].transpose(1, 2)[:, :T_voc])
                        outs.append(out)
                    out = self._gather(outs)
                    # decode clips the lengths to the bucket
                    out["mel_lengths_host"] = np.minimum(y_host[bi], T_y).astype(np.int32)
                    self.corpus_frames_true += int(out["mel_lengths_host"].sum())
                    self.corpus_frames_decoded += B * T_y
                yield chunk, out

    @staticmethod
    def _lengths_host(batches: list) -> list:
        """Each batch's predicted lengths on the host, from its parts'
        ``(replica, rows, ..., y_lengths)``: one copy per replica of all
        its parts, in order."""
        flat = [p for parts in batches for p in parts]
        host = [None] * len(flat)
        for rep in {id(p[0]): p[0] for p in flat}.values():
            mine = [i for i, p in enumerate(flat) if p[0] is rep]
            vals = torch.cat([flat[i][-1] for i in mine]).cpu().numpy()
            cuts = np.cumsum([flat[i][-1].shape[0] for i in mine])[:-1]
            for i, v in zip(mine, np.split(vals, cuts)):
                host[i] = v
        out, k = [], 0
        for parts in batches:
            out.append(np.concatenate(host[k:k + len(parts)]))
            k += len(parts)
        return out


def _eager_span(name: str, x: torch.Tensor):
    """``tracing.span(name)`` around eager work on ``x``, and nothing while a
    CUDA graph captures it: a capture runs this host code once, a replay
    never."""
    if tracing.enabled() and x.is_cuda and torch.cuda.is_current_stream_capturing():
        return contextlib.nullcontext()
    return tracing.span(name)


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``; any other device as it is."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor onto ``device`` without the host waiting for the card
    (through pinned memory on a GPU)."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# ---------------------------------------------------------------------------
# model loading
# ---------------------------------------------------------------------------


def get_user_data_dir(appname: str = "matcha_tpu") -> Path:
    """``$MATCHA_HOME/<appname>``, else ``~/.local/share/<appname>``."""
    home = os.environ.get("MATCHA_HOME")
    base = Path(home).expanduser() if home is not None else Path.home() / ".local" / "share"
    return base / appname


def _checked(path, url: Optional[str] = None) -> Path:
    path = Path(path)
    if not path.exists():
        published = f"; the published file is {url}" if url else ""
        raise FileNotFoundError(f"checkpoint not found: {path} (nothing is downloaded){published}")
    return path


def _get(d, k, default=None):
    try:
        return d[k]
    except (KeyError, TypeError):
        return default


def matcha_kwargs(hp) -> dict:
    """MatchaTTS constructor arguments from a reference checkpoint's
    ``hyper_parameters``."""
    enc = _get(hp, "encoder")
    dec = _get(hp, "decoder")
    enc_p = _get(enc, "encoder_params")
    dp_p = _get(enc, "duration_predictor_params")
    kwargs = dict(n_vocab=int(_get(hp, "n_vocab", 178)), n_spks=int(_get(hp, "n_spks", 1)),
                  spk_emb_dim=int(_get(hp, "spk_emb_dim", 64)),
                  n_feats=int(_get(hp, "n_feats", 80)))
    if enc_p is not None:
        kwargs.update(
            enc_n_channels=int(_get(enc_p, "n_channels", 192)),
            enc_filter_channels=int(_get(enc_p, "filter_channels", 768)),
            enc_filter_channels_dp=int(_get(enc_p, "filter_channels_dp", 256)),
            enc_n_heads=int(_get(enc_p, "n_heads", 2)),
            enc_n_layers=int(_get(enc_p, "n_layers", 6)),
            enc_kernel_size=int(_get(enc_p, "kernel_size", 3)),
            enc_prenet=bool(_get(enc_p, "prenet", True)),
        )
    if dp_p is not None:
        kwargs.update(dp_kernel_size=int(_get(dp_p, "kernel_size", 3)))
    if dec is not None:
        kwargs.update(
            dec_channels=tuple(_get(dec, "channels", (256, 256))),
            dec_attention_head_dim=int(_get(dec, "attention_head_dim", 64)),
            dec_n_blocks=int(_get(dec, "n_blocks", 1)),
            dec_num_mid_blocks=int(_get(dec, "num_mid_blocks", 2)),
            dec_num_heads=int(_get(dec, "num_heads", 2)),
            dec_act_fn=str(_get(dec, "act_fn", "snakebeta")),
            **{f"dec_{stage}_block_type": str(_get(dec, f"{stage}_block_type", "transformer"))
               for stage in ("down", "mid", "up")},
            dec_conformer_batch_norm=bool(_get(dec, "conformer_batch_norm", False)),
        )
    return kwargs


def load_matcha(checkpoint_path, device=None) -> MatchaTTS:
    """A Matcha checkpoint -> MatchaTTS on ``device``. Either the port's
    native checkpoint (a ``checkpoint_<step>`` or ``last`` file with its
    ``.hparams.json`` beside it): ``MatchaTTS(**hparams["model_kwargs"])``,
    as JAX builds its native ones, so the default (LJSpeech) widths when
    the json names none, which is what the trainers write; a checkpoint of
    other widths then fails the strict load, naming the keys. Or a
    reference Lightning ``.ckpt`` (a trusted file: it is unpickled in
    full, for its hyper-parameters)."""
    path = _checked(checkpoint_path)
    print(f"[!] Loading {path.name}!")
    if Path(f"{path}.hparams.json").exists():
        payload = load_native_checkpoint(str(path))
        kwargs = payload["hparams"].get("model_kwargs", {})
        model = MatchaTTS(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in kwargs.items()})
        model.load_state_dict(payload["model"])
        print(f"[+] {path.name} loaded!")
        return model.to(resolve_device(device)).eval()
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = dict(ckpt["state_dict"])
    hp = ckpt.get("hyper_parameters", {})
    stats = _get(hp, "data_statistics", {})
    sd.setdefault("mel_mean", torch.tensor(float(_get(stats, "mel_mean", 0.0))))
    sd.setdefault("mel_std", torch.tensor(float(_get(stats, "mel_std", 1.0))))
    model = MatchaTTS(**matcha_kwargs(hp))
    model.load_state_dict(sd)
    print(f"[+] {path.name} loaded!")
    return model.to(resolve_device(device)).eval()


def load_vocoder(checkpoint_path, device=None, name: str = "hifigan_T2_v1"):
    """A reference HiFi-GAN v1 generator file of the vocoder ``name`` (one
    of ``VOCODER_URLS``; both are v1) -> (Generator with weight norm
    folded, denoiser bias spectrum from its output on a zero mel)."""
    if name not in VOCODER_URLS:
        raise NotImplementedError(
            f"Vocoder {name} not implemented! define a load_<<vocoder_name>> method for it")
    path = _checked(checkpoint_path)
    print(f"[!] Loading {path.name}!")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["generator"] if "generator" in ckpt else ckpt
    vocoder = Generator(HiFiGANConfig())
    vocoder.load_state_dict(fold_hifigan_state_dict(sd))
    device = resolve_device(device)
    vocoder = vocoder.to(device).eval()
    bias = compute_bias_spec(lambda mel: generator_apply_fused(vocoder, mel), device=device)
    print(f"[+] {path.name} loaded!")
    return vocoder, bias


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _texts(args) -> list:
    if args.text:
        return [args.text]
    with open(args.file, encoding="utf-8") as f:
        return [line for line in f if line.strip()]


def _rtf(seconds: float, n_samples: int) -> float:
    return seconds * SAMPLE_RATE / max(n_samples, 1)


def _save(folder: Path, name: str, mel: np.ndarray, wav: np.ndarray) -> Path:
    """``<name>.png`` (the mel's plot), ``<name>.npy`` (the mel,
    (n_feats, frames)) and ``<name>.wav``, as JAX's ``save_to_folder``."""
    base = folder / name
    save_plot(mel, base.with_suffix(".png"))
    np.save(base.with_suffix(".npy"), mel)
    write_wav(base.with_suffix(".wav"), wav)
    return base.with_suffix(".wav").resolve()


def _print_rtf_summary(rtfs) -> None:
    print(f"[🍵] Average Matcha-TTS + VOCODER RTF: {np.mean(rtfs):.4f} ± {np.std(rtfs)}")


def resolve_speaker(model: MatchaTTS, spk: Optional[int]) -> Optional[int]:
    """The speaker the CLI and the daemon run, checked against the loaded
    model (``validate_args`` knows only the named models; a custom
    checkpoint may have any ``n_spks``): a multi-speaker model without
    ``--spk`` warns and takes speaker 0 (the ``matcha_vctk`` default); an
    id outside [0, n_spks) exits with the range; a single-speaker model
    warns and ignores ``--spk``."""
    if model.n_spks <= 1:
        if spk is not None:
            warnings.warn(f"[-] Ignoring speaker id {spk} for a single-speaker model", UserWarning)
        return None
    if spk is None:
        warnings.warn("[!] Speaker ID not provided! Using speaker ID 0", UserWarning)
        return 0
    try:
        check_speakers(model.n_spks, [spk])
    except ValueError as e:
        raise SystemExit(f"--spk: {e}") from e
    return int(spk)


def _name(i: int, spk: Optional[int]) -> str:
    """``utterance_<i>``, with ``_speaker_<spk>`` for a multi-speaker run."""
    return f"utterance_{i:03d}" if spk is None else f"utterance_{i:03d}_speaker_{spk:03d}"


def speaker_batch(spk: Optional[int], B: int) -> Optional[np.ndarray]:
    """One speaker id for a batch of B, or None."""
    return None if spk is None else np.full((B,), spk, np.int32)


def unbatched_synthesis(args, pipeline: TTSPipeline, texts, folder: Path) -> None:
    """One utterance per call: ``utterance_<i>[_speaker_<spk>].wav`` /
    ``.npy``, i from 1."""
    rtfs = []
    for i, text in enumerate(texts, start=1):
        tp = process_text(i, text.strip(), pipeline.cleaner)
        generator = torch.Generator(pipeline.device).manual_seed(args.seed + i)
        t0 = time.perf_counter()
        out, wavs, mls = synth_fetch_guarded(
            pipeline, tp["x"], tp["x_lengths"], n_timesteps=args.steps,
            temperature=args.temperature, length_scale=args.speaking_rate,
            generator=generator, fixed_y_bucket=args.fixed_y_bucket, spks=speaker_batch(args.spk, 1))
        ml = int(mls[0])
        wav = wavs[0, :ml * HOP]
        rtfs.append(_rtf(time.perf_counter() - t0, wav.shape[-1]))
        print(f"[🍵-{i}] Matcha-TTS + VOCODER RTF: {rtfs[-1]:.4f}")
        location = _save(folder, _name(i, args.spk), out["mel"][0, :, :ml].cpu().numpy(), wav)
        print(f"[+] Waveform saved: {location}")
    _print_rtf_summary(rtfs)


def staged_batched_synthesis(args, pipeline: TTSPipeline, texts, folder: Path) -> None:
    """``--batched --staged``: the corpus protocol (``synthesise_corpus``,
    one host copy of lengths per window of batches), writing what
    ``batched_synthesis`` writes; the RTF is the whole corpus's, since
    every encoder pass of a window is launched up front. The noise of every
    batch comes from one generator seeded with ``--seed``."""
    processed = [process_text(i, t.strip(), pipeline.cleaner) for i, t in enumerate(texts)]
    utts = [p["x"][0] for p in processed]
    generator = torch.Generator(pipeline.device).manual_seed(args.seed)
    t0 = time.perf_counter()
    total_samples = 0
    true0, decoded0 = pipeline.corpus_frames_true, pipeline.corpus_frames_decoded
    for chunk, out in pipeline.synthesise_corpus(
            utts, n_timesteps=args.steps, temperature=args.temperature,
            length_scale=args.speaking_rate, batch_size=args.batch_size,
            fuse_stages=args.fused_stage, generator=generator, spk=args.spk):
        wavs, mel = out["waveform"].cpu().numpy(), out["mel"].cpu().numpy()
        for row, idx in enumerate(chunk):
            ml = int(out["mel_lengths_host"][row])
            location = _save(folder, _name(idx, args.spk), mel[row, :, :ml],
                             wavs[row, :ml * HOP])
            print(f"[🍵-{idx}] Waveform saved: {location}")
        total_samples += int(out["mel_lengths_host"].sum()) * HOP
    rtf = _rtf(time.perf_counter() - t0, total_samples)
    print(f"[🍵] Corpus Matcha-TTS + VOCODER RTF: {rtf:.4f} ({len(texts)} utterances)")
    true, decoded = (pipeline.corpus_frames_true - true0,
                     pipeline.corpus_frames_decoded - decoded0)
    print(f"[🍵] Corpus frame fill: {100 * true / max(decoded, 1):.1f} % ({true} speech frames "
          f"of {decoded} decoded; the rest pads each batch to its mel bucket)")
    _print_rtf_summary([rtf])


def batched_synthesis(args, pipeline: TTSPipeline, texts, folder: Path) -> None:
    """Length-sorted batches of ``--batch_size``, one call each:
    ``utterance_<idx>.wav`` / ``.npy`` with idx the 0-based line, as the
    JAX CLI names them."""
    processed = [process_text(i, t.strip(), pipeline.cleaner) for i, t in enumerate(texts)]
    order = sorted(range(len(processed)), key=lambda i: processed[i]["x"].shape[-1])
    rtfs = []
    for bi, start in enumerate(range(0, len(order), args.batch_size)):
        chunk = order[start:start + args.batch_size]
        x = np.zeros((len(chunk), max(processed[i]["x"].shape[-1] for i in chunk)), np.int32)
        x_lengths = np.zeros((len(chunk),), np.int32)
        for row, idx in enumerate(chunk):
            xi = processed[idx]["x"][0]
            x[row, :xi.shape[-1]] = xi
            x_lengths[row] = xi.shape[-1]
        generator = torch.Generator(pipeline.device).manual_seed(args.seed + bi)
        t0 = time.perf_counter()
        out, wavs, mls = synth_fetch_guarded(
            pipeline, x, x_lengths, n_timesteps=args.steps, temperature=args.temperature,
            length_scale=args.speaking_rate, generator=generator,
            fixed_y_bucket=args.fixed_y_bucket, spks=speaker_batch(args.spk, len(chunk)))
        rtfs.append(_rtf(time.perf_counter() - t0, int(np.sum(mls)) * HOP))
        print(f"[🍵-Batch: {bi + 1}] Matcha-TTS + VOCODER RTF: {rtfs[-1]:.4f}")
        mel = out["mel"].cpu().numpy()
        for row, idx in enumerate(chunk):
            ml = int(mls[row])
            location = _save(folder, _name(idx, args.spk), mel[row, :, :ml],
                             wavs[row, :ml * HOP])
            print(f"[🍵-{idx}] Waveform saved: {location}")
    _print_rtf_summary(rtfs)


def long_form_synthesis(args, pipeline: TTSPipeline, text: str, folder: Path) -> None:
    """Sentence-chunked synthesis of a long ``--text``
    (``text/segment.py``): each chunk through the same buckets, the
    waveforms and mels concatenated into ``utterance_long_form``."""
    chunks = split_sentences(text)
    print(f"[🍵] Long-form input: {len(chunks)} chunks")
    wavs, mels = [], []
    t0 = time.perf_counter()
    for ci, chunk in enumerate(chunks):
        tp = process_text(ci, chunk, pipeline.cleaner)
        generator = torch.Generator(pipeline.device).manual_seed(args.seed + ci)
        out, wavs_h, mls_h = synth_fetch_guarded(
            pipeline, tp["x"], tp["x_lengths"], n_timesteps=args.steps,
            temperature=args.temperature, length_scale=args.speaking_rate,
            generator=generator, fixed_y_bucket=args.fixed_y_bucket, spks=speaker_batch(args.spk, 1))
        ml = int(mls_h[0])
        wavs.append(wavs_h[0, :ml * HOP])
        mels.append(out["mel"][0, :, :ml].cpu().numpy())
    wav = np.concatenate(wavs)
    print(f"[🍵] Long-form RTF (incl. vocoder): {_rtf(time.perf_counter() - t0, wav.shape[-1]):.4f}"
          f" for {wav.shape[-1] / SAMPLE_RATE:.1f}s of audio")
    location = _save(folder, "utterance_long_form", np.concatenate(mels, axis=1), wav)
    print(f"[+] Waveform saved: {location}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="🍵 Matcha-TTS (PyTorch port): text to speech with conditional flow matching")
    parser.add_argument("--model", type=str, default="matcha_ljspeech",
                        choices=list(MATCHA_URLS.keys()),
                        help="Model, read from $MATCHA_HOME/matcha_tpu/<model>.ckpt "
                             "(default: matcha_ljspeech)")
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="A custom Matcha checkpoint: a Lightning .ckpt or the port's native "
                             "checkpoint_<step> (its .hparams.json beside it)")
    parser.add_argument("--vocoder", type=str, default=None, choices=list(VOCODER_URLS.keys()),
                        help="Vocoder, read from $MATCHA_HOME/matcha_tpu/<vocoder> (default: the "
                             "model's own; hifigan_univ_v1 for a custom checkpoint)")
    parser.add_argument("--text", type=str, default=None, help="Text to synthesize")
    parser.add_argument("--file", type=str, default=None, help="Text file to synthesize, one utterance per line")
    parser.add_argument("--temperature", type=float, default=0.667, help="Variance of the x0 noise (default: 0.667)")
    parser.add_argument("--speaking_rate", type=float, default=None,
                        help="Higher is slower (default: 0.95 for LJSpeech, 0.85 for VCTK, 1.0 "
                             "for a custom checkpoint)")
    parser.add_argument("--steps", type=int, default=10, help="Number of ODE steps (default: 10)")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (default: CUDA)")
    parser.add_argument("--denoiser_strength", type=float, default=0.00025,
                        help="Strength of the vocoder bias denoiser (default: 0.00025)")
    parser.add_argument("--output_folder", type=str, default=os.getcwd(),
                        help="Output folder (default: current dir)")
    parser.add_argument("--batched", action="store_true",
                        help="Synthesize --file in length-sorted batches of --batch_size")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="Batch size, with --batched (default: 32)")
    parser.add_argument("--long-form", action="store_true",
                        help="Synthesize a long --text sentence by sentence into one wav")
    parser.add_argument("--seed", type=int, default=1234, help="Noise seed (default 1234)")
    parser.add_argument("--spk", type=int, default=None,
                        help="Speaker ID of a multi-speaker model, in [0, n_spks) (default 0, "
                             "with a warning); ignored, with a warning, by a single-speaker one")
    parser.add_argument("--cleaner", type=str, default="english_cleaners2",
                        help="Text cleaner (english_cleaners_no_espeak works without espeak)")
    parser.add_argument("--fixed-y-bucket", type=lambda s: s if s == "auto" else int(s), default=0,
                        help="Run the whole text->wav path at this mel bucket as one CUDA graph "
                             "(no host sync; a saturated result re-runs on the dynamic path). "
                             "'auto' = the self-calibrating tightest bucket. 0 = dynamic bucket "
                             "pick (default)")
    parser.add_argument("--no-pcm24-transfer", action="store_true",
                        help="Fixed-bucket path: fetch the waveform as f32 instead of 24-bit "
                             "PCM packed on the device (the written-WAV encoding)")
    parser.add_argument("--staged", action="store_true",
                        help="With --batched: staged corpus synthesis (every batch's encoder "
                             "pass first, one host copy of all predicted lengths, then decode + "
                             "vocode per batch with no other host sync)")
    parser.add_argument("--fused-stage", action="store_true",
                        help="With --staged: run decode + vocode + denoise as one CUDA graph "
                             "per (mel bucket, vocoder bucket) triple instead of separate calls")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Shard batches over ALL visible GPUs (data-parallel serving: the "
                             "models replicate once per GPU, each batch's rows split over the "
                             "replicas). Pick --batch_size a multiple of the GPU count. A no-op "
                             "with one GPU")
    parser.add_argument("--vocoder-chunk", type=int, default=0,
                        help="Run the vocoder on N-frame mel windows (with a receptive-field "
                             "halo, one after another) to bound its activation memory. 0 = the "
                             "whole utterance (default)")
    parser.add_argument("--full-precision", action="store_true",
                        help="Turn TF32 off for cuDNN convolutions and for matmuls, so that f32 "
                             "runs in full f32. Without it torch's defaults stand: cuDNN "
                             "convolutions in TF32, matmuls in full f32")
    parser.add_argument("--bf16-latency", action="store_true",
                        help="With --fixed-y-bucket: run the CFM Euler loop on a bf16 copy of the "
                             "decoder and the vocoder in bf16. The encoder and the durations stay "
                             "f32, so the mel lengths equal the f32 path's")
    parser.add_argument("--bf16-vocoder", action="store_true",
                        help="Run the vocoder with bf16 weights and activations on every path "
                             "(cuDNN convs in bf16; the fused MRF kernel computes in f32 inside). "
                             "The clip, the denoiser and the PCM packing stay f32")
    parser.add_argument("--no-pallas-vocoder", action="store_true",
                        help="Run every vocoder stage as cuDNN convs instead of the fused MRF "
                             "kernel on the narrow stages")
    parser.add_argument("--trace-spans", type=str, default=None, metavar="PATH",
                        help="Record the pipeline's spans (utils/tracing.py: pipeline.*, "
                             "models.*) and write them as a Chrome trace JSON file at the end")
    return parser


def assert_required_models_available(args) -> dict:
    """The local files of ``args.model`` (or ``args.checkpoint_path``) and
    ``args.vocoder`` under ``$MATCHA_HOME/matcha_tpu/``: {"matcha": path,
    "vocoder": path}. A missing file raises FileNotFoundError naming its
    published URL; nothing is downloaded."""
    home = get_user_data_dir()
    if args.checkpoint_path is not None:
        model_path = _checked(args.checkpoint_path)
    else:
        model_path = _checked(home / f"{args.model}.ckpt", MATCHA_URLS[args.model])
    vocoder_path = _checked(home / f"{args.vocoder}", VOCODER_URLS[args.vocoder])
    return {"matcha": model_path, "vocoder": vocoder_path}


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise SystemExit(message)


def validate_args(args):
    """JAX's argument checks: each model's default vocoder, speaking rate
    and speaker, the "I would suggest passing --vocoder" warnings, the
    VCTK speaker range, and ``--spk`` ignored for LJSpeech; a custom
    checkpoint takes ``hifigan_univ_v1`` and rate 1.0 by default. An
    invalid argument exits with JAX's message."""
    _require(bool(args.text or args.file), "Either text or file must be provided Matcha-T(ea)TTS "
             "need sometext to whisk the waveforms.")
    _require(args.temperature >= 0, "Sampling temperature cannot be negative")
    _require(args.steps > 0, "Number of ODE steps must be greater than 0")

    if args.checkpoint_path is None:
        if args.model in SINGLESPEAKER_MODEL:
            args = _validate_single_speaker(args)
        if args.model in MULTISPEAKER_MODEL:
            args = _validate_multispeaker(args)
    else:
        if args.vocoder != "hifigan_univ_v1":
            warnings.warn(
                "[-] Using custom model checkpoint! I would suggest passing --vocoder "
                "hifigan_univ_v1, unless the custom model is trained on LJ Speech.", UserWarning)
        if args.speaking_rate is None:
            args.speaking_rate = 1.0
        if args.vocoder is None:
            args.vocoder = "hifigan_univ_v1"

    if args.batched:
        _require(args.batch_size > 0, "Batch size must be greater than 0")
    _require(args.speaking_rate > 0, "Speaking rate must be greater than 0")
    return args


def _validate_multispeaker(args):
    info = MULTISPEAKER_MODEL[args.model]
    if args.vocoder is not None:
        if args.vocoder != info["vocoder"]:
            warnings.warn(f"[-] Using {args.model} model! I would suggest passing --vocoder "
                          f"{info['vocoder']}", UserWarning)
    else:
        args.vocoder = info["vocoder"]
    if args.speaking_rate is None:
        args.speaking_rate = info["speaking_rate"]
    spk_range = info["spk_range"]
    if args.spk is not None:
        _require(spk_range[0] <= args.spk <= spk_range[-1],
                 f"Speaker ID must be between {spk_range} for this model.")
    else:
        warnings.warn(f"[!] Speaker ID not provided! Using speaker ID {info['spk']}", UserWarning)
        args.spk = info["spk"]
    return args


def _validate_single_speaker(args):
    info = SINGLESPEAKER_MODEL[args.model]
    if args.vocoder is not None:
        if args.vocoder != info["vocoder"]:
            warnings.warn(f"[-] Using {args.model} model! I would suggest passing --vocoder "
                          f"{info['vocoder']}", UserWarning)
    else:
        args.vocoder = info["vocoder"]
    if args.speaking_rate is None:
        args.speaking_rate = info["speaking_rate"]
    if args.spk != info["spk"]:
        warnings.warn(f"[-] Ignoring speaker id {args.spk} for {args.model}", UserWarning)
        args.spk = info["spk"]
    return args


def print_config(args) -> None:
    print("[!] Configurations: ")
    print(f"\t- Model: {args.model}")
    print(f"\t- Vocoder: {args.vocoder}")
    print(f"\t- Temperature: {args.temperature}")
    print(f"\t- Speaking rate: {args.speaking_rate}")
    print(f"\t- Number of ODE steps: {args.steps}")
    print(f"\t- Speaker: {args.spk}")


def data_parallel_devices(data_parallel: bool, device: torch.device) -> Optional[list]:
    """``--data-parallel``: every visible GPU, one replica each, or None
    (one device: the flag is a no-op, as JAX's with a 1-device mesh)."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if not data_parallel or n < 2:
        return None
    print(f"[+] Data-parallel serving over {n} devices")
    return [torch.device("cuda", i) for i in range(n)]


def cli(argv=None):
    args = validate_args(build_parser().parse_args(argv))
    if args.vocoder_chunk < 0:
        raise SystemExit("--vocoder-chunk must be >= 0")
    device = resolve_device("cpu" if args.cpu else None)
    if args.full_precision:  # JAX's jax_default_matmul_precision = "highest"
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[+] Device: {device}")
    print_config(args)
    paths = assert_required_models_available(args)
    if args.checkpoint_path is not None:
        print(f"[🍵] Loading custom model from {args.checkpoint_path}")
        args.model = "custom_model"

    model = load_matcha(paths["matcha"], device)
    args.spk = resolve_speaker(model, args.spk)
    vocoder, bias = load_vocoder(paths["vocoder"], device, name=args.vocoder)
    devices = data_parallel_devices(args.data_parallel, device)
    pipeline = TTSPipeline(model, vocoder, bias, cleaner=args.cleaner,
                           device=devices[0] if devices else device,
                           denoiser_strength=args.denoiser_strength,
                           pcm24_transfer=not args.no_pcm24_transfer,
                           vocoder_chunk=args.vocoder_chunk, vocoder_bf16=args.bf16_vocoder,
                           vocoder_pallas=not args.no_pallas_vocoder,
                           bf16_latency=args.bf16_latency, devices=devices)

    texts = _texts(args)
    folder = Path(args.output_folder)
    folder.mkdir(parents=True, exist_ok=True)
    if args.trace_spans:
        tracing.enable()
    try:
        if args.long_form and args.text:
            long_form_synthesis(args, pipeline, args.text, folder)
        elif len(texts) == 1 or not args.batched:
            unbatched_synthesis(args, pipeline, texts, folder)
        elif args.staged:
            staged_batched_synthesis(args, pipeline, texts, folder)
        else:
            batched_synthesis(args, pipeline, texts, folder)
    finally:
        if args.trace_spans:
            tracing.disable()
            n = tracing.write_chrome(args.trace_spans)
            print(f"[+] {n} spans written to {args.trace_spans}")


if __name__ == "__main__":
    cli(sys.argv[1:])
