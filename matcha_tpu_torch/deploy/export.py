"""Deployment export: the synthesis graph as a ``torch.export`` artifact.

The port of ``matcha_tpu/deploy/export.py``. The deployment unit is a
``.pt2`` file (``torch.export.save``) of one fixed-shape graph:

* signature ``(x, x_lengths, scales, z) -> (mel, mel_lengths)`` or, with
  a vocoder, ``-> (wav, wav_lengths)`` (``wav_lengths = mel_lengths *
  hop``); ``scales = [temperature, length_scale]``;
* ``z`` is the unit-normal noise (B, T_y, n_feats): JAX's artifact takes a
  PRNG key, but a ``torch.Generator`` cannot be an exported input;
* n_timesteps is baked in at export, and the batch and both time axes are
  fixed: export one artifact per bucket;
* the artifact carries its weights (``deploy/infer.py`` replaces the
  Matcha ones with a checkpoint's, as JAX passes its params in);
* the vocoder is the plain generator, as in JAX's artifact (no fused MRF
  kernel inside);
* the graph records the device it was exported on: export on the device
  that will run it.

    python -m matcha_tpu_torch.deploy.export <checkpoint> <output.pt2> [flags]
"""

import argparse
import os
import time
from typing import Optional

import torch
from torch import nn

from matcha_tpu_torch import resolve_device
from matcha_tpu_torch.ops.seq import sequence_mask


def vocoder_hop(vocoder) -> int:
    """Samples per mel frame of a HiFi-GAN generator."""
    hop = 1
    for u in vocoder.h.upsample_rates:
        hop *= int(u)
    return hop


class ExportableTTS(nn.Module):
    """JAX's exportable ``fn`` as a module: ids -> mel, or -> wav with a
    vocoder. Its weights are ``matcha.*`` and ``vocoder.*``."""

    def __init__(self, model: nn.Module, vocoder: Optional[nn.Module] = None,
                 n_timesteps: int = 5, T_y: int = 1024):
        super().__init__()
        self.matcha = model
        self.vocoder = vocoder
        self.n_timesteps = int(n_timesteps)
        self.T_y = int(T_y)
        self.hop = 1 if vocoder is None else vocoder_hop(vocoder)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, scales: torch.Tensor,
                z: torch.Tensor):
        temperature, length_scale = scales[0], scales[1]
        x_mask = sequence_mask(x_lengths, x.shape[1]).float()[..., None]
        mu_x, logw = self.matcha.encoder(x, x_mask, None)
        # no clamp on logw, as in JAX's export
        w = torch.exp(logw) * x_mask
        w_ceil = torch.ceil(w) * length_scale
        y_lengths = torch.clamp(w_ceil.sum(dim=(1, 2)), min=1.0)
        y_lengths = torch.clamp(y_lengths, max=float(self.T_y)).to(torch.int32)
        out = self.matcha.decode_body(mu_x, w_ceil, x_lengths, y_lengths, self.n_timesteps,
                                      temperature, self.T_y, z)
        if self.vocoder is None:
            return out["mel"], out["mel_lengths"]
        wav = self.vocoder.generate(out["mel"])[:, 0]
        return torch.clamp(wav, -1.0, 1.0), out["mel_lengths"] * self.hop


def get_exportable_fn(model, with_vocoder=None, n_timesteps: int = 5,
                      T_y: int = 1024) -> ExportableTTS:
    """The deployable module: ``forward(x, x_lengths, scales, z)``, scales
    = [temperature, length_scale], z unit normal (B, T_y, n_feats)."""
    return ExportableTTS(model, with_vocoder, n_timesteps, T_y).eval()


def example_inputs(batch: int, T_x: int, T_y: int, n_feats: int, device) -> tuple:
    """(x, x_lengths, scales, z) of the artifact's shapes and types."""
    return (torch.zeros((batch, T_x), dtype=torch.long, device=device),
            torch.full((batch,), T_x, dtype=torch.long, device=device),
            torch.tensor([0.667, 1.0], dtype=torch.float32, device=device),
            torch.zeros((batch, T_y, n_feats), dtype=torch.float32, device=device))


def export_graph(model, path: str, batch: int = 1, T_x: int = 256, T_y: int = 1024,
                 n_timesteps: int = 5, with_vocoder=None):
    """Export at a fixed (batch, T_x, T_y) on the model's device and save
    the ``.pt2``; returns the ``ExportedProgram``."""
    device = next(model.parameters()).device
    fn = get_exportable_fn(model, with_vocoder, n_timesteps, T_y).to(device)
    args = example_inputs(batch, T_x, T_y, model.n_feats, device)
    with torch.no_grad():
        ep = torch.export.export(fn, args, strict=False)
    torch.export.save(ep, path)
    print(f"[🍵] Exported {os.path.getsize(path) / 1e6:.1f} MB torch.export artifact to {path}")
    print(f"     signature: (x[{batch},{T_x}], x_lengths[{batch}], scales[2], "
          f"z[{batch},{T_y},{model.n_feats}]) n_timesteps={n_timesteps} T_y={T_y} "
          f"vocoder={'yes' if with_vocoder is not None else 'no'} device={device}")
    return ep


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Export Matcha-TTS (PyTorch port) to a "
                                                 "torch.export artifact")
    parser.add_argument("checkpoint_path", type=str,
                        help="Matcha checkpoint (Lightning .ckpt or the port's native one)")
    parser.add_argument("output", type=str, help="Output artifact path (.pt2)")
    parser.add_argument("--vocoder-name", type=str, default=None,
                        choices=["hifigan_T2_v1", "hifigan_univ_v1"])
    parser.add_argument("--vocoder-checkpoint-path", type=str, default=None,
                        help="the vocoder file (default: $MATCHA_HOME/matcha_tpu/<name>)")
    parser.add_argument("--n-timesteps", type=int, default=5,
                        help="ODE steps baked in at export (default 5, like the reference)")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--t-x", type=int, default=256, help="text bucket length")
    parser.add_argument("--t-y", type=int, default=1024, help="mel bucket length")
    parser.add_argument("--cpu", action="store_true", help="export for the CPU (default: CUDA)")
    args = parser.parse_args(argv)

    from matcha_tpu_torch.cli import get_user_data_dir, load_matcha, load_vocoder

    device = resolve_device("cpu" if args.cpu else None)
    model = load_matcha(args.checkpoint_path, device)
    vocoder = None
    if args.vocoder_name or args.vocoder_checkpoint_path:
        name = args.vocoder_name or "hifigan_univ_v1"
        vocoder, _ = load_vocoder(args.vocoder_checkpoint_path or get_user_data_dir() / name,
                                  device, name=name)
    t0 = time.perf_counter()
    export_graph(model, args.output, args.batch, args.t_x, args.t_y, args.n_timesteps, vocoder)
    print(f"     exported in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
