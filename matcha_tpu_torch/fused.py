"""Fixed-shape bodies captured as one CUDA graph each: the fixed-bucket
serving path, and the flow (split) or the decode + vocode stage (fused)
of staged corpus synthesis.

``FusedGraph`` is the counterpart of ``matcha_tpu/cli.py::TTSPipeline._fused_fn``.
At one (B, x bucket, mel bucket, steps, temperature, length scale,
denoiser strength, wire format) the whole path is one body of fixed
shapes: encoder -> duration expansion -> the CFM Euler loop -> HiFi-GAN
over the whole mel bucket -> clip -> denoiser -> the wire packing (24-bit
PCM with the mel lengths as a last sample, or the f32 rows with the
lengths as a last column).

``DecodeGraph`` is the flow of the split corpus path: the CFM Euler loop
and the denormalisation at one (B, mel bucket), fed with the expanded
``mu_y`` that ``MatchaTTS.align`` computes eagerly before it; the
vocoder runs eagerly after it. It has no counterpart in JAX, whose split
path jit-compiles the whole decode per bucket.

``StageGraph`` is the counterpart of ``TTSPipeline._decode_vocode_fn``:
stage 3 of ``synthesise_corpus`` at one (B, x bucket, mel bucket, vocoder
bucket, steps, temperature, denoiser strength), decode -> slice the mel
to the vocoder bucket -> HiFi-GAN -> clip -> denoiser, fed with stage 1's
encoder outputs.

On a GPU each body is captured once as a ``torch.cuda.CUDAGraph`` and
replayed: one launch from the host per call, the fused MRF kernel (K1,
``ops/mrf.py``) inside it. On the CPU the same body runs eagerly; that is
the plain version the tests hold against the JAX package.

A body captured for a multi-speaker model (``has_spk``) reads its speaker
ids from a static buffer, staged like the other inputs: the embedding
lookup runs inside the graph, so one capture serves every speaker at its
shapes.

Spans (``utils/tracing.py``), outside what a graph captures: a call's
``pipeline.stage_inputs`` (the copies into the static buffers and the
noise draw), then ``pipeline.replay`` (the launch and the output clones)
or, at a first call, ``pipeline.capture``.

Capture fails loudly: a body raises and never runs eagerly in its place.
Only an explicit ``cuda_graph=False`` runs it eagerly on a GPU. A
pipeline whose ``capture_allowed`` is False (the serving daemon after its
warmup) refuses any new capture.
"""

from typing import Dict, Optional

import numpy as np
import torch

from matcha_tpu_torch.utils import tracing
from matcha_tpu_torch.utils.utils import pack_pcm24


def _stage(dst: torch.Tensor, src) -> None:
    """Write ``src`` (a numpy array or a tensor of ``dst``'s shape) into
    the static buffer ``dst``, cast to its dtype (an array on the host). A
    host source goes through pinned memory, so the copy into a GPU buffer
    queues on the stream and the host does not wait for the card."""
    src = (src.to(dst.dtype) if torch.is_tensor(src)
           else torch.as_tensor(np.asarray(src), dtype=dst.dtype))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"input of shape {tuple(src.shape)}, the graph takes {tuple(dst.shape)}")
    if dst.is_cuda and src.device.type == "cpu":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


class CapturedBody:
    """A body of fixed shapes over static input buffers: captured as a
    CUDA graph at its first call on a GPU and replayed after, run eagerly
    on the CPU or with ``cuda_graph=False``. Its static inputs: the buffers
    ``inputs`` names, the unit noise ``z`` (B, T_y, n_feats) and, with
    ``has_spk``, (B,) int64 speaker ids ``spks`` (else None).

    ``pipeline``: a ``pipeline.TTSPipeline``. ``cuda_graph``: None =
    capture on a GPU, run eagerly on the CPU; False runs eagerly on either.
    ``pool``: the graph memory pool shared by a pipeline's graphs
    (``torch.cuda.graph_pool_handle()``). After a replay the returned
    tensors are copies: the next replay of any graph in the pool
    overwrites the static outputs. Subclasses allocate the buffers of
    ``inputs`` on ``self.device`` and define ``body`` and ``describe``.
    """

    #: the names of the static input buffers a call stages, in its order
    inputs: tuple = ()

    def __init__(self, pipeline, B: int, T_y: int, has_spk: bool,
                 cuda_graph: Optional[bool] = None, pool=None):
        device = pipeline.device
        if cuda_graph is None:
            cuda_graph = device.type == "cuda"
        if cuda_graph and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.pipeline, self.device = pipeline, device
        self.cuda_graph, self.pool = cuda_graph, pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Dict[str, torch.Tensor]] = None
        #: memory_allocated before and after the warm-up and the capture
        self.memory_allocated: Optional[tuple] = None
        #: calls so far (eager runs, or a capture and its replay, or replays)
        self.calls = 0
        #: replays run so far
        self.replays = 0
        self.spks = torch.zeros((B,), dtype=torch.int64, device=device) if has_spk else None
        self.T_y = T_y
        self.z = torch.zeros((B, T_y, pipeline.model.n_feats), dtype=torch.float32,
                             device=device)

    #: the body's name in error messages
    name = "captured"

    def body(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def describe(self) -> str:
        """The body's shapes, for error messages."""
        raise NotImplementedError

    def _capture(self) -> None:
        """Warm the body up eagerly on the capture stream (cuFFT plans,
        cuDNN and cuBLAS workspaces, K1's library and its shared-memory
        attribute), then capture it. Raises if the body cannot be
        captured, or if the pipeline no longer allows captures."""
        if not self.pipeline.capture_allowed:
            raise RuntimeError(
                f"a capture of the {self.name} graph ({self.describe()}) was asked for after the pipeline "
                f"closed captures: only graphs captured before (the daemon's warmup) replay")
        dev = self.device
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            self.body()
            stream.synchronize()
            try:
                graph.capture_begin(pool=self.pool)
                try:
                    outputs = self.body()
                finally:
                    graph.capture_end()
            except RuntimeError as e:
                raise RuntimeError(
                    f"capturing the {self.name} graph ({self.describe()}) failed; nothing ran in its "
                    f"place: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.graph, self.outputs = graph, outputs
        self.memory_allocated = (before, torch.cuda.memory_allocated(dev))

    @torch.inference_mode()
    def __call__(self, *args, z=None, generator: Optional[torch.Generator] = None,
                 spks: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        """The inputs that ``inputs`` names, in order (arrays or tensors of
        their buffers' shapes), then ``z``, ``generator`` and ``spks``,
        positionally or by name -> the body's outputs. ``z``: the unit
        noise (B, T_y, n_feats); else drawn from ``generator`` into the
        static buffer, outside the graph. ``spks``: checked host speaker
        ids (B,), for a body built with ``has_spk`` only."""
        n = len(self.inputs)
        if not n <= len(args) <= n + 3:
            raise TypeError(f"the {self.name} graph takes {self.inputs}, z, generator and spks")
        z, generator, spks = args[n:] + (z, generator, spks)[len(args) - n:]
        with tracing.span("pipeline.stage_inputs"):
            if (spks is None) != (self.spks is None):
                raise ValueError(f"the {self.name} graph ({self.describe()}) was built "
                                 f"{'with' if self.spks is not None else 'without'} speaker ids")
            for name, src in zip(self.inputs, args):
                _stage(getattr(self, name), src)
            if spks is not None:
                _stage(self.spks, spks)
            if z is not None:
                _stage(self.z, z)
            else:
                self.z.normal_(generator=generator)
        return self._run()

    def _run(self) -> Dict[str, torch.Tensor]:
        """The body on the static inputs: eagerly, or a replay (captured
        at the first call)."""
        self.calls += 1
        if not self.cuda_graph:
            return self.body()
        if self.graph is None:
            with tracing.span("pipeline.capture", graph=self.name, shapes=self.describe()):
                self._capture()
        with tracing.span("pipeline.replay"):
            self.graph.replay()
            self.replays += 1
            return {k: v.clone() for k, v in self.outputs.items()}


class FusedGraph(CapturedBody):
    """One bucket's text -> wav body with static input buffers.

    Static inputs: ``x`` (B, T_x) int64 ids, ``x_lengths`` (B,) int32,
    ``z`` and, with ``has_spk``, ``spks``; the temperature, like every
    other key field, is a constant of the body.

    Calling it returns the ``synthesise`` dict plus ``waveform`` (B, T_y *
    hop) and ``wav_pcm24`` or ``wav_packed`` when the pipeline has a
    vocoder.
    """

    name = "fused"
    inputs = ("x", "x_lengths")

    def __init__(self, pipeline, B: int, T_x: int, T_y: int, n_timesteps: int,
                 temperature: float, length_scale: float, pcm24: bool, has_spk: bool = False,
                 cuda_graph: Optional[bool] = None, pool=None):
        super().__init__(pipeline, B, T_y, has_spk, cuda_graph, pool)
        self.n_timesteps = n_timesteps
        self.temperature, self.length_scale, self.pcm24 = temperature, length_scale, pcm24
        self.x = torch.zeros((B, T_x), dtype=torch.int64, device=self.device)
        self.x_lengths = torch.ones((B,), dtype=torch.int32, device=self.device)

    def describe(self) -> str:
        return f"B, T_x = {tuple(self.x.shape)}, T_y = {self.T_y}"

    def body(self) -> Dict[str, torch.Tensor]:
        """The whole path on the static inputs (what the graph captures).
        With the pipeline's ``bf16_latency``: the Euler loop on its bf16
        decoder copy (the f32 noise buffer cast inside) and the vocoder in
        bf16, as JAX's ``_fused_fn``."""
        p = self.pipeline
        lat = p.bf16_latency
        model = p.latency_model if lat else p.model
        out = model.synthesise(self.x, self.x_lengths, self.n_timesteps, self.temperature,
                               self.length_scale, y_max_length=self.T_y, z=self.z,
                               compute_dtype=torch.bfloat16 if lat else None, spks=self.spks)
        if p.vocoder is not None:
            wav = p.vocode(out["mel"].transpose(1, 2), bf16=True if lat else None)
            out["waveform"] = wav
            if self.pcm24:
                out["wav_pcm24"] = pack_pcm24(wav, out["mel_lengths"])
            else:
                out["wav_packed"] = torch.cat(
                    [wav, out["mel_lengths"][:, None].to(torch.float32)], dim=1)
        return out


class StageGraph(CapturedBody):
    """Stage 3 of staged corpus synthesis at one (B, T_x, T_y, T_voc):
    decode -> the mel sliced to ``T_voc`` frames -> vocode -> clip ->
    denoise (``TTSPipeline.vocode_decoded``), with static inputs ``mu_x``
    (B, T_x, n_feats), ``w_ceil`` (B, T_x, 1), ``x_lengths`` and
    ``y_lengths`` (B,) int32 (stage 1's device tensors, copied in on the
    device), ``z`` and, with ``has_spk``, ``spks``.

    Calling it returns the ``decode`` dict plus ``waveform`` (B, T_voc *
    hop) and ``first_sample`` (the waveform's [0, 0], as JAX's stage
    returns it). The pipeline must have a vocoder.
    """

    name = "stage"
    inputs = ("mu_x", "w_ceil", "x_lengths", "y_lengths")

    def __init__(self, pipeline, B: int, T_x: int, T_y: int, T_voc: int, n_timesteps: int,
                 temperature: float, has_spk: bool = False, cuda_graph: Optional[bool] = None,
                 pool=None):
        super().__init__(pipeline, B, T_y, has_spk, cuda_graph, pool)
        self.T_voc = T_voc
        self.n_timesteps, self.temperature = n_timesteps, temperature
        device, n_feats = self.device, pipeline.model.n_feats
        self.mu_x = torch.zeros((B, T_x, n_feats), dtype=torch.float32, device=device)
        self.w_ceil = torch.zeros((B, T_x, 1), dtype=torch.float32, device=device)
        self.x_lengths = torch.ones((B,), dtype=torch.int32, device=device)
        self.y_lengths = torch.ones((B,), dtype=torch.int32, device=device)

    def describe(self) -> str:
        return f"B, T_x = {tuple(self.mu_x.shape[:2])}, T_y = {self.T_y}, T_voc = {self.T_voc}"

    def body(self) -> Dict[str, torch.Tensor]:
        p = self.pipeline
        out = p.vocode_decoded(
            p.model.decode(self.mu_x, self.w_ceil, self.x_lengths, self.y_lengths,
                           self.n_timesteps, self.temperature, y_max_length=self.T_y, z=self.z,
                           spks=self.spks), self.T_voc)
        out["first_sample"] = out["waveform"][0, 0]
        return out


class DecodeGraph(CapturedBody):
    """The CFM flow of the split corpus path at one (B, T_y): the Euler
    loop of the U-Net and the denormalisation (``MatchaTTS.flow``), with
    static inputs ``mu_y`` (B, T_y, n_feats) and ``y_mask`` (B, T_y, 1)
    (``MatchaTTS.align``'s device tensors, copied in on the device), ``z``
    and, with ``has_spk``, ``spks``. The key has no x or vocoder bucket:
    the alignment runs eagerly before it, the vocoder after it; the noise
    drawn from a generator is what ``decode`` would draw.

    Calling it returns ``decoder_outputs`` and ``mel``, each (B, n_feats,
    T_y).
    """

    name = "decode"
    inputs = ("mu_y", "y_mask")

    def __init__(self, pipeline, B: int, T_y: int, n_timesteps: int, temperature: float,
                 has_spk: bool = False, cuda_graph: Optional[bool] = None, pool=None):
        super().__init__(pipeline, B, T_y, has_spk, cuda_graph, pool)
        self.n_timesteps, self.temperature = n_timesteps, temperature
        device, n_feats = self.device, pipeline.model.n_feats
        self.mu_y = torch.zeros((B, T_y, n_feats), dtype=torch.float32, device=device)
        self.y_mask = torch.zeros((B, T_y, 1), dtype=torch.float32, device=device)

    def describe(self) -> str:
        return f"B, T_y = {tuple(self.mu_y.shape[:2])}"

    def body(self) -> Dict[str, torch.Tensor]:
        model = self.pipeline.model
        decoder_outputs, mel = model.flow(self.mu_y, self.y_mask, self.n_timesteps,
                                          self.temperature, self.z,
                                          spk_emb=model._speaker(self.spks))
        return {"decoder_outputs": decoder_outputs, "mel": mel}
