"""Matcha-TTS in PyTorch for NVIDIA Hopper (H100).

A port of the ``matcha_tpu`` serving path (phoneme ids -> wav), its
training path (``python -m matcha_tpu_torch.train``), its vocoder GAN
training (``python -m matcha_tpu_torch.training.vocoder_train``), its
deployment (``deploy/export.py``, ``deploy/infer.py``: ``torch.export``
artifacts), evaluation (``eval.py``), the app's backend (``app.py``) and
tools (``text/phonemize.py``, ``training/sweep.py``) that keeps the
reference torch parameter names, so a reference checkpoint or a bridged
JAX param tree (``matcha_tpu_torch.convert``) loads as-is. Three
hand-written CUDA kernels: the fused HiFi-GAN MRF stage (``ops/mrf.py``,
``csrc/mrf_stage.cu``), the same stage on channels-last activations
(``ops/mrf_phase.py``, ``csrc/mrf_phase.cu``) and Monotonic Alignment
Search (``ops/mas.py``, ``csrc/mas.cu``); everything else is plain torch.
The vocoder profilers are ``python -m matcha_tpu_torch.scripts.profile_vocoder``
and ``...profile_vocoder_stages``.

Entry points run on CUDA unless the caller passes ``device="cpu"`` (for
training, ``trainer.accelerator=cpu``).
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Raises when no device is given and no GPU is present —
    never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' (or --cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
