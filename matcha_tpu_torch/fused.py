"""The fixed-bucket serving path: ids -> waveform in one call, one CUDA graph per bucket.

The counterpart of ``matcha_tpu/cli.py::TTSPipeline._fused_fn``. At one
(B, x bucket, mel bucket, steps, temperature, length scale, denoiser
strength, wire format) the whole path is one body of fixed shapes:
encoder -> duration expansion -> the CFM Euler loop -> HiFi-GAN over the
whole mel bucket -> clip -> denoiser -> the wire packing (24-bit PCM with
the mel lengths as a last sample, or the f32 rows with the lengths as a
last column). On a GPU that body is captured once as a
``torch.cuda.CUDAGraph`` and replayed: one launch from the host per
request, the fused MRF kernel (K1, ``ops/mrf.py``) inside it. On the CPU
the same body runs eagerly; that is the plain version the tests hold
against the JAX package.

Capture fails loudly: ``FusedGraph`` raises and never runs the body
eagerly in its place. Only an explicit ``cuda_graph=False`` runs it
eagerly on a GPU.
"""

import time
from typing import Dict, Optional

import numpy as np
import torch

from matcha_tpu_torch.utils.utils import PCM24_SCALE


def _pack_pcm24(wav: torch.Tensor, mel_lengths: torch.Tensor) -> torch.Tensor:
    """(B, n) f32 waveform -> (B, 3n+3) uint8 little-endian 24-bit PCM on
    the waveform's device (clip, scale by 2^23-1, truncate toward zero,
    low 3 bytes), with mel_lengths appended as one trailing sample per
    row."""
    v = (torch.clamp(wav, -1.0, 1.0) * PCM24_SCALE).to(torch.int32)
    v = torch.cat([v, mel_lengths[:, None].to(torch.int32)], dim=1)
    b = torch.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], dim=-1)
    return b.to(torch.uint8).reshape(v.shape[0], -1)


def _stage(dst: torch.Tensor, src) -> None:
    """Write ``src`` (a numpy array or a tensor of ``dst``'s shape) into
    the static buffer ``dst``. A host source goes through pinned memory,
    so the copy into a GPU buffer queues on the stream and the host does
    not wait for the card."""
    src = torch.as_tensor(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"input of shape {tuple(src.shape)}, the graph takes {tuple(dst.shape)}")
    if dst.is_cuda and src.device.type == "cpu":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


class FusedGraph:
    """One bucket's text -> wav body with static input buffers.

    ``pipeline``: a ``cli.TTSPipeline`` (its model, vocoder, denoiser bias
    and strength). Static inputs: ``x`` (B, T_x) int64 ids, ``x_lengths``
    (B,) int32 and ``z`` (B, T_y, n_feats) f32 unit noise; the
    temperature, like every other key field, is a constant of the body.
    ``cuda_graph``: None = capture on a GPU, run eagerly on the CPU; False
    runs eagerly on either. ``pool``: the graph memory pool shared by a
    pipeline's graphs (``torch.cuda.graph_pool_handle()``).

    Calling it returns the ``synthesise`` dict plus ``waveform`` (B, T_y *
    hop) and ``wav_pcm24`` or ``wav_packed`` when the pipeline has a
    vocoder. After a replay the returned tensors are copies: the next
    replay of any graph in the pool overwrites the static outputs.
    """

    def __init__(self, pipeline, B: int, T_x: int, T_y: int, n_timesteps: int,
                 temperature: float, length_scale: float, pcm24: bool,
                 cuda_graph: Optional[bool] = None, pool=None):
        device = pipeline.device
        if cuda_graph is None:
            cuda_graph = device.type == "cuda"
        if cuda_graph and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.pipeline = pipeline
        self.T_y, self.n_timesteps = T_y, n_timesteps
        self.temperature, self.length_scale, self.pcm24 = temperature, length_scale, pcm24
        self.cuda_graph, self.pool = cuda_graph, pool
        self.x = torch.zeros((B, T_x), dtype=torch.int64, device=device)
        self.x_lengths = torch.ones((B,), dtype=torch.int32, device=device)
        self.z = torch.zeros((B, T_y, pipeline.model.n_feats), dtype=torch.float32, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Dict[str, torch.Tensor]] = None
        #: seconds of warm-up + capture, and memory_allocated around them
        self.capture_seconds: Optional[float] = None
        self.memory_allocated: Optional[tuple] = None

    def body(self) -> Dict[str, torch.Tensor]:
        """The whole path on the static inputs (what the graph captures)."""
        p = self.pipeline
        out = p.model.synthesise(self.x, self.x_lengths, self.n_timesteps, self.temperature,
                                 self.length_scale, y_max_length=self.T_y, z=self.z)
        if p.vocoder is not None:
            wav = p.vocode(out["mel"].transpose(1, 2))
            out["waveform"] = wav
            if self.pcm24:
                out["wav_pcm24"] = _pack_pcm24(wav, out["mel_lengths"])
            else:
                out["wav_packed"] = torch.cat(
                    [wav, out["mel_lengths"][:, None].to(torch.float32)], dim=1)
        return out

    def _capture(self) -> None:
        """Warm the body up eagerly on the capture stream (cuFFT plans,
        cuDNN and cuBLAS workspaces, K1's library and its shared-memory
        attribute), then capture it. Raises if the body cannot be
        captured."""
        dev = self.x.device
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
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
                    f"capturing the fused graph (B, T_x = {tuple(self.x.shape)}, T_y = "
                    f"{self.T_y}) failed; nothing ran in its place: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.graph, self.outputs = graph, outputs
        self.capture_seconds = time.perf_counter() - t0
        self.memory_allocated = (before, torch.cuda.memory_allocated(dev))

    @torch.inference_mode()
    def __call__(self, x: np.ndarray, x_lengths: np.ndarray, z=None,
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Padded ids (B, T_x) and lengths (B,) -> the body's outputs.
        ``z``: the unit noise (B, T_y, n_feats); else drawn from
        ``generator`` into the static buffer, outside the graph."""
        _stage(self.x, np.asarray(x, dtype=np.int64))
        _stage(self.x_lengths, np.asarray(x_lengths, dtype=np.int32))
        if z is not None:
            _stage(self.z, z.to(torch.float32) if torch.is_tensor(z) else np.asarray(z, np.float32))
        else:
            self.z.normal_(generator=generator)
        if not self.cuda_graph:
            return self.body()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return {k: v.clone() for k, v in self.outputs.items()}
