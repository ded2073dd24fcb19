"""The synthesis pipeline of the port: phoneme ids -> mel -> waveform.

Port of ``matcha_tpu/cli.py``'s ``TTSPipeline`` and its three paths:
- the dynamic path: encode -> host pick of the mel bucket -> decode ->
  slice to the finer vocoder bucket -> vocode (the fused-MRF generator)
  -> clip -> denoise -> optional 24-bit PCM packing;
- the fixed-bucket path (``fixed_y_bucket``): the whole text -> wav body
  at one mel bucket, one CUDA graph per bucket on a GPU (``fused.py``),
  with the self-calibrating ``"auto"`` bucket, its saturation escalation
  and the top-bucket fallback to the dynamic path;
- staged corpus synthesis (``synthesise_corpus``): every batch's encoder
  pass of a window first, one host copy of their predicted lengths, then
  decode + vocode per batch with no other host sync, split (the
  decoder's flow as one CUDA graph per (B, mel bucket), the vocoder
  eagerly) or (``fuse_stages``) as one CUDA graph per bucket triple.
With ``vocoder_chunk`` every path vocodes in N-frame mel windows with a
halo. Precision, as in JAX: ``vocoder_bf16`` runs every path's vocoder
on a bf16 copy of the generator; ``bf16_latency`` runs the fixed-bucket
body's Euler loop on a bf16 copy of the decoder and its vocoder in bf16;
``vocoder_pallas=False`` runs the generator all on cuDNN, no fused MRF
kernel.
Data-parallel serving (``TTSPipeline(devices=)``): one replica of the
models per device; a batch whose size divides by the replica count is
split into contiguous rows, one part per replica (JAX's ``data`` axis),
and the results are gathered on the first device in input order. The
noise is drawn at the whole batch's shape on the first device and each
replica gets its rows, so the output equals one device's.
A multi-speaker model (the VCTK Matcha) takes a speaker id on every path
(``spks``), checked on the host against the model's ``n_spks`` before it
reaches the card. The front ends (``cli.py``, ``serve.py``, ``app.py``,
``scripts/``) share its id padding, buckets and decode -> vocode step.
"""

import collections
import contextlib
import copy
import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch

from matcha_tpu_torch import resolve_device
from matcha_tpu_torch.fused import DecodeGraph, FusedGraph, StageGraph
from matcha_tpu_torch.models import bigvgan
from matcha_tpu_torch.models.denoiser import denoise
from matcha_tpu_torch.models.hifigan import Generator
from matcha_tpu_torch.models.hifigan_fused import (
    MAX_FUSED_CHANNELS,
    fused_stage_weights,
    generator_apply_fused,
)
from matcha_tpu_torch.models.matcha import MatchaTTS, check_speakers, decoder_cast
from matcha_tpu_torch.parallel.mesh import replica_rows
from matcha_tpu_torch.utils import tracing
from matcha_tpu_torch.utils.utils import pack_pcm24, pcm24_lengths, unpack_pcm24

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


def voc_bucket(max_y: int, T_y: int) -> int:
    """The vocoder bucket of a batch decoded at the mel bucket ``T_y``
    whose longest mel is ``max_y`` frames: on ``VOC_BUCKETS``, at most T_y."""
    return min(T_y, pick_bucket(min(max_y, T_y), VOC_BUCKETS))


def pad_ids(rows, T_x: int, B: Optional[int] = None, dtype=np.int32):
    """Rows of phoneme ids (each at most ``T_x``) -> (ids (B, T_x) of
    ``dtype``, zero-padded, and their lengths (B,) int32); a ``B`` above
    the row count adds rows of padding, each of length 1."""
    B = len(rows) if B is None else B
    x = np.zeros((B, T_x), dtype)
    lengths = np.ones((B,), np.int32)
    for i, row in enumerate(rows):
        x[i, :len(row)] = row
        lengths[i] = len(row)
    return x, lengths


def speaker_batch(spk: Optional[int], B: int) -> Optional[np.ndarray]:
    """One speaker id for a batch of B, or None."""
    return None if spk is None else np.full((B,), spk, np.int32)


def fetch_fused_host(out: dict):
    """A fixed-bucket result's (waveform, mel_lengths) on the host, in one
    copy, whichever wire format the graph packed (``wav_pcm24``,
    ``wav_packed``, or the plain f32 waveform and lengths). The ``"auto"``
    path has already fetched into ``*_host`` keys for its saturation
    check; integer-bucket callers use this."""
    if "waveform_host" in out:
        return out["waveform_host"], np.asarray(out["mel_lengths_host"])
    if "pcm24_bytes_host" in out:  # raw_pcm24 delivery, already fetched
        return unpack_pcm24(out["pcm24_bytes_host"])
    if "wav_pcm24" in out:
        return unpack_pcm24(out["wav_pcm24"].cpu().numpy())
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
        ml = pcm24_lengths(out["pcm24_bytes_host"])
    elif "wav_pcm24" in out or "wav_packed" in out:
        out["waveform_host"], ml = fetch_fused_host(out)
    else:
        ml = out["mel_lengths"].cpu().numpy()
    out["mel_lengths_host"] = ml
    return ml


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
        if isinstance(vocoder, bigvgan.Generator):
            for flag, on in (("vocoder_bf16", vocoder_bf16), ("bf16_latency", bf16_latency),
                             ("vocoder_chunk", vocoder_chunk)):
                if on:
                    raise ValueError(
                        f"{flag} with a BigVGAN vocoder: BigVGAN runs in float32 only, and "
                        f"the chunk halo (VOC_CHUNK_HALO) is HiFi-GAN's receptive field, not "
                        f"BigVGAN's")
        self._vocoders = {}
        if vocoder is not None:
            self._vocoders[False] = self._packed(vocoder)
            if vocoder_bf16 or bf16_latency:
                self._vocoders[True] = self._packed(
                    copy.deepcopy(vocoder).to(torch.bfloat16).eval())
        self.vocoder = None if vocoder is None else self._vocoders[vocoder_bf16][0]
        #: ``hifigan`` or ``bigvgan`` (the ``models.vocode`` span's ``arch``)
        self.vocoder_arch = (None if vocoder is None else
                             "bigvgan" if isinstance(vocoder, bigvgan.Generator) else "hifigan")
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
        #: the split path's batches whose decode graph was captured at that
        #: batch (on the CPU or with ``cuda_graph=False``: built and run
        #: eagerly for a new (B, T_y)) and those that replayed one built before
        self.corpus_decode_captures = 0
        self.corpus_decode_replays = 0
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

    def _packed(self, vocoder) -> tuple:
        """(generator, its fused stages' packed weights under this
        pipeline's cap, or None, and the call mel (B, T, n_feats) -> (B, T *
        hop, 1) that ``_generate`` makes), chosen here once by the
        generator's class: HiFi-GAN through ``generator_apply_fused``, BigVGAN
        its own forward on its snake terms computed now (K4 on a GPU unless
        ``vocoder_pallas`` is False)."""
        if isinstance(vocoder, bigvgan.Generator):
            fused = self.vocoder_pallas
            vocoder.prepare()
            return vocoder, None, lambda mel: vocoder(mel, fused=fused)
        weights = fused_stage_weights(vocoder, self.max_fused_channels)
        cap = self.max_fused_channels
        return vocoder, weights, lambda mel: generator_apply_fused(vocoder, mel, weights,
                                                                   max_fused_channels=cap)

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
        call = self._vocoders[bf16][2]
        mel = mel_btc.to(torch.bfloat16) if bf16 else mel_btc

        def run(m):
            out = call(m)
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
        ``models.vocode`` (the generator and the clip; attributes ``arch``,
        ``B`` and ``T_voc``) and ``models.denoise``, except while a CUDA graph
        captures the call."""
        with _eager_span("models.vocode", mel_btc, arch=self.vocoder_arch, B=mel_btc.shape[0],
                         T_voc=mel_btc.shape[1]):
            wav = torch.clamp(self._generate(mel_btc, bf16)[..., 0], -1.0, 1.0)
        if self.denoiser_bias is None:
            return wav
        with _eager_span("models.denoise", wav):
            return denoise(wav, self.denoiser_bias, strength=self.denoiser_strength)

    def vocode_decoded(self, out: dict, T_voc: int, pack: bool = False) -> dict:
        """The decode -> vocode step: ``decode``'s dict ``out`` plus the
        waveform of its mel's first ``T_voc`` frames (``waveform``, (B,
        T_voc * hop)), or with ``pack`` in its place those samples packed
        with the lengths (``wav_pcm24``); ``out`` as it was without a
        vocoder."""
        if self.vocoder is None:
            return out
        wav = self.vocode(out["mel"].transpose(1, 2)[:, :T_voc])
        if pack:
            out["wav_pcm24"] = pack_pcm24(wav, out["mel_lengths"])
        else:
            out["waveform"] = wav
        return out

    def fused_graph(self, B: int, T_x: int, T_y: int, n_timesteps: int, temperature: float,
                    length_scale: float, cuda_graph: Optional[bool] = None,
                    has_spk: bool = False) -> FusedGraph:
        """The cached fixed-bucket body for this key (``_fused_fn``'s key
        fields, ``has_spk`` among them, plus B, the wire format and the
        graph mode; the port has no key fold)."""
        return self._graph((B, T_x, T_y, n_timesteps, temperature, length_scale, has_spk,
                            float(self.denoiser_strength), self.pcm24_transfer, cuda_graph),
                           FusedGraph, B, T_x, T_y, n_timesteps, temperature, length_scale,
                           self.pcm24_transfer, has_spk, cuda_graph=cuda_graph)

    def stage_graph(self, B: int, T_x: int, T_y: int, T_voc: int, n_timesteps: int,
                    temperature: float, cuda_graph: Optional[bool] = None,
                    has_spk: bool = False) -> StageGraph:
        """The cached decode + vocode stage for this key (``_decode_vocode_fn``'s
        key fields plus B, ``has_spk``, the denoiser strength and the graph
        mode)."""
        return self._graph(("stage", B, T_x, T_y, T_voc, n_timesteps, temperature, has_spk,
                            float(self.denoiser_strength), cuda_graph),
                           StageGraph, B, T_x, T_y, T_voc, n_timesteps, temperature, has_spk,
                           cuda_graph=cuda_graph)

    def decode_graph(self, B: int, T_y: int, n_timesteps: int, temperature: float,
                     cuda_graph: Optional[bool] = None, has_spk: bool = False) -> DecodeGraph:
        """The cached flow of the split corpus path for this key (B, the
        mel bucket, the steps, the temperature, ``has_spk`` and the graph
        mode; no x or vocoder bucket)."""
        return self._graph(("decode", B, T_y, n_timesteps, temperature, has_spk, cuda_graph),
                           DecodeGraph, B, T_y, n_timesteps, temperature, has_spk,
                           cuda_graph=cuda_graph)

    def _graph(self, key: tuple, cls, *args, cuda_graph: Optional[bool]):
        """The graph of ``key``, built at its first use as ``cls(self,
        *args, cuda_graph, pool)`` in the memory pool that all of the
        pipeline's graphs share."""
        if key not in self._graphs:
            if self._graph_pool is None and self.device.type == "cuda" and cuda_graph is not False:
                self._graph_pool = torch.cuda.graph_pool_handle()
            self._graphs[key] = cls(self, *args, cuda_graph, self._graph_pool)
        return self._graphs[key]

    def observe_dur_ratio(self, obs: float) -> None:
        """Fold one non-saturated fixed-bucket result into the
        frames-per-token calibration of ``fit_y_bucket``: the 90th
        percentile of the last 64 observations, not an all-time maximum,
        so that one long-winded utterance does not push every later
        request onto a larger bucket for good. An underestimate costs the
        one call a re-run at a larger bucket; an overestimate taxes every
        call."""
        self._dur_obs.append(float(obs))
        self._dur_ratio = float(np.quantile(np.asarray(self._dur_obs), 0.9))

    def fit_y_bucket(self, buckets, n_ids: int, length_scale: float) -> int:
        """The tightest of the ascending fixed mel ``buckets`` that holds
        ``n_ids`` ids at ``length_scale`` by the calibrated frames per id
        with ``FUSED_MARGIN`` of headroom, else the largest (before any
        calibration: always right, just not tight)."""
        if self._dur_ratio is None:
            return buckets[-1]
        est = n_ids * length_scale * self._dur_ratio * self.FUSED_MARGIN
        return next((b for b in buckets if b >= est), buckets[-1])

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
        mean clipped audio, which ``cli.synth_fetch_guarded`` checks.
        ``cuda_graph=False`` runs the body eagerly on the GPU.

        ``"auto"``: the bucket that ``fit_y_bucket`` fits over
        ``FUSED_Y_BUCKETS``. One host copy carries the wav and the lengths
        (``waveform_host`` and ``mel_lengths_host``); a result that reached
        its bucket re-runs at the first bucket of at least twice the size,
        and one that reached the largest falls back to the dynamic path
        with a warning. Only results that did not saturate calibrate the
        ratio. ``raw_pcm24`` (pcm24 wire): deliver the packed rows as
        ``pcm24_bytes_host`` instead of the f32 ``waveform_host``, also
        through the fallback.

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
            x_pad, _ = pad_ids(x, T_x, dtype=np.int64)

            if fixed_y_bucket:
                auto = fixed_y_bucket == "auto"
                T_y = (self.fit_y_bucket(self.FUSED_Y_BUCKETS, int(x_lengths_host.max()),
                                         length_scale)
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
            T_voc = voc_bucket(max_y, T_y)
            span.set(T_x=T_x, T_y=T_y, T_voc=T_voc)
            zs = self._noise_parts(z(T_y) if callable(z) else z, (x.shape[0], T_y), generator, parts)
            outs = []
            for (rep, _), (xl, spks_t, mu_x, w_ceil, y_lengths), zr in zip(parts, encoded, zs):
                with tracing.span("models.decode"):
                    out = rep.model.decode(mu_x, w_ceil, xl, y_lengths, n_timesteps, temperature,
                                           y_max_length=T_y, z=zr, generator=generator,
                                           spks=spks_t)
                outs.append(rep.vocode_decoded(out, T_voc, pack_wav))
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
           the host, then decode and vocode: split, the alignment eagerly,
           the flow as one call of ``fused.py::DecodeGraph`` (a CUDA graph
           per (B, T_y) on a GPU, captured at its first use) and the
           vocoder eagerly; or with ``fuse_stages`` one call of the stage's
           body (``fused.py::StageGraph``: a CUDA graph per (B, T_x, T_y,
           T_voc) on a GPU); no other host sync.
        Stage 1 keeps a window's encoder outputs on the card until stage 3
        reaches them, so the window bounds that memory.

        Noise per batch: ``z(batch_index, B, T_y)`` with ``batch_index`` the
        batch's place in the sorted corpus (JAX folds it into its key),
        else drawn from ``generator`` (on the pipeline's device) batch by
        batch. ``cuda_graph=False`` runs the decode graph's body or the
        fused stage eagerly on a GPU; on the CPU both always run eagerly.
        ``spk``: one speaker id for the whole corpus (a multi-speaker
        model), checked on the host first.

        Yields ``(utterance indices, out)`` per batch in sorted order:
        ``out`` is the ``decode`` dict plus ``waveform`` (B, T_voc * hop)
        (and ``first_sample`` when fused), and ``mel_lengths_host``, the
        lengths already on the host.

        Spans (``utils/tracing.py``): ``pipeline.corpus.encode`` and
        ``pipeline.corpus.lengths`` per window, ``pipeline.corpus.batch`` per
        batch, the ``models.*`` calls inside them on the split path (the
        decode graph's ``pipeline.stage_inputs``, and ``pipeline.capture`` or
        ``pipeline.replay`` on a GPU, inside ``models.decode``). Counters:
        ``corpus_frames_true`` and ``corpus_frames_decoded``;
        ``corpus_decode_captures`` and ``corpus_decode_replays`` on the
        split path.
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
                    x, x_lengths = (torch.from_numpy(a) for a in pad_ids(
                        [utterances[i] for i in chunk], T_x, dtype=np.int64))
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
                T_voc = voc_bucket(max_y, T_y)
                with tracing.span("pipeline.corpus.batch", B=B, T_x=T_x, T_y=T_y, T_voc=T_voc):
                    zs = self._noise_parts(None if z is None else z(w0 + bi, B, T_y), (B, T_y),
                                           generator, [p[:2] for p in parts], graph=True)
                    outs, new = [], False
                    for (rep, rows, xlr, spks_t, mu_x, w_ceil, y_lengths), zr in zip(parts, zs):
                        if fused:
                            stage = rep.stage_graph(rows.stop - rows.start, T_x, T_y, T_voc,
                                                    n_timesteps, temperature, cuda_graph,
                                                    spks is not None)
                            out = stage(mu_x, w_ceil, xlr, y_lengths, zr, generator,
                                        None if spks is None else spks[rows])
                        else:
                            with tracing.span("models.decode"):
                                attn, mu_y, y_mask, y_clip = rep.model.align(
                                    mu_x, w_ceil, xlr, y_lengths, T_y)
                                flow = rep.decode_graph(rows.stop - rows.start, T_y, n_timesteps,
                                                        temperature, cuda_graph, spks is not None)
                                new |= flow.calls == 0
                                flowed = flow(mu_y, y_mask, zr, generator,
                                              None if spks is None else spks[rows])
                            out = rep.vocode_decoded(rep.model.decode_dict(
                                attn, mu_y, y_clip, flowed["decoder_outputs"], flowed["mel"]),
                                T_voc)
                        outs.append(out)
                    out = self._gather(outs)
                    # decode clips the lengths to the bucket
                    out["mel_lengths_host"] = np.minimum(y_host[bi], T_y).astype(np.int32)
                    self.corpus_frames_true += int(out["mel_lengths_host"].sum())
                    self.corpus_frames_decoded += B * T_y
                    if not fused:
                        self.corpus_decode_captures += new
                        self.corpus_decode_replays += not new
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


def _eager_span(name: str, x: torch.Tensor, **attrs):
    """``tracing.span(name, **attrs)`` around eager work on ``x``, and nothing
    while a CUDA graph captures it: a capture runs this host code once, a
    replay never."""
    if tracing.enabled() and x.is_cuda and torch.cuda.is_current_stream_capturing():
        return contextlib.nullcontext()
    return tracing.span(name, **attrs)


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
