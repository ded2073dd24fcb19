"""A configuration's vocoder, by its architecture.

A configuration file names its vocoder's architecture under
``"vocoder_arch"``, and the harness reaches the vocoder only through the
module of that name in this package: ``adapter(cfg)`` imports
``benchmark.harness.vocoders.<vocoder_arch>``. A new architecture comes in
as a new module here (its plain reference under
``benchmark/reference/models/``), with no edit to any other file of the
harness. The module provides four functions; ``vocoder_cfg`` is the
configuration's ``"vocoder"`` object as the file holds it:

- ``system(vocoder_cfg, device) -> nn.Module``: the system's generator on
  ``device``, unseeded. The harness seeds it with
  ``weights.seeded_state_dict`` from ``derive_seed(seed, "weights",
  "vocoder")``.
- ``reference(vocoder_cfg, device) -> nn.Module``: the plain reference's
  generator on ``device``, unseeded, its parameters named as the
  system's, so that one seed gives both the same weights. The judge calls
  ``forward(mel (B, T, n_mels)) -> wav (B, T * hop, 1)``, in float32 and
  (the control) with bfloat16 weights and mel; ``flops.ModelFlops``
  counts ``generate(mel (B, n_mels, T))``, which has to run on the
  ``meta`` device.
- ``pipeline_kwargs(vocoder, device) -> dict``: the keyword arguments of
  the system's ``TTSPipeline`` that the architecture sets, given the
  system's seeded generator: the vocoder itself and its denoiser bias
  (``denoiser_bias``, None where it is not denoised).
- ``reference_bias(vocoder, device) -> Tensor | None``: the reference's
  denoiser bias, given its seeded generator; None: the reference does
  not denoise.
"""

import importlib
import pkgutil
import re

_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def known() -> list:
    """The architectures that have a module here."""
    return sorted(m.name for m in pkgutil.iter_modules(__path__))


def adapter(cfg: dict):
    """The module of ``cfg["vocoder_arch"]``. ``ValueError`` where the key is
    missing or names no module: there is no default architecture."""
    arch = cfg.get("vocoder_arch")
    if arch is None:
        raise ValueError(f"configuration {cfg.get('name')!r} names no 'vocoder_arch'; "
                         f"one of {known()}")
    if not isinstance(arch, str) or not _NAME.match(arch):
        raise ValueError(f"vocoder_arch {arch!r} is no module name; one of {known()}")
    name = f"{__name__}.{arch}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"vocoder_arch {arch!r} has no module {name}; one of {known()}") from None
