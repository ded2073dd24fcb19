"""Run a ``torch.export`` synthesis artifact (the onnx/infer analog).

The port of ``matcha_tpu/deploy/infer.py``: loads a ``.pt2`` written by
``matcha_tpu_torch.deploy.export``, puts a checkpoint's Matcha weights
into it (``load_state_dict(strict=True)``: the checkpoint must have the
artifact's widths; an embedded vocoder keeps the artifact's weights, as
JAX's keeps the ones baked in) and synthesises a line-per-utterance file:

* lines are padded into the artifact's batch dimension and run in
  batches of B;
* the noise z of a batch starting at line ``start`` comes from a
  ``torch.Generator`` on the artifact's device seeded with ``seed +
  start`` (JAX: ``PRNGKey(seed + start)``);
* three output modes: an artifact with an embedded vocoder -> wavs; a mel
  artifact with ``--vocoder-name``/``--vocoder-checkpoint-path`` -> wavs
  from that (plain) generator; a mel artifact alone -> ``.npy`` + ``.png``;
* the RTF of each batch and their mean, by the reference's formula.

    python -m matcha_tpu_torch.deploy.infer <artifact.pt2> <checkpoint> --file lines.txt
"""

import argparse
import os
import time

import numpy as np
import torch

from matcha_tpu_torch.deploy.export import vocoder_hop
from matcha_tpu_torch.utils.utils import save_plot, write_wav

SAMPLE_RATE, HOP = 22050, 256


def write_wav_outputs(wavs, lengths, indices, output_dir):
    for row, idx in enumerate(indices):
        n = int(lengths[row])
        write_wav(os.path.join(output_dir, f"output_{idx + 1}.wav"), wavs[row][:n])


def write_mel_outputs(mels, lengths, indices, output_dir):
    for row, idx in enumerate(indices):
        n = int(lengths[row])
        mel = mels[row][:, :n]
        np.save(os.path.join(output_dir, f"output_{idx + 1}.npy"), mel)
        save_plot(mel, os.path.join(output_dir, f"output_{idx + 1}.png"))


def artifact_inputs(ep) -> dict:
    """The user inputs' example values of an exported program, by name:
    x, x_lengths, scales, z (shapes, types and the device it records)."""
    vals = {n.name: n.meta["val"] for n in ep.graph.nodes if n.op == "placeholder"}
    return dict(zip(("x", "x_lengths", "scales", "z"),
                    (vals[name] for name in ep.graph_signature.user_inputs)))


def with_weights(ep, model) -> torch.nn.Module:
    """The exported program's module with ``model``'s weights in place of
    its Matcha ones: the keys must be exactly the artifact's, of the same
    shapes (a strict load)."""
    module = ep.module()
    state = {k: v for k, v in module.state_dict().items() if not k.startswith("matcha.")}
    state.update({f"matcha.{k}": v for k, v in model.state_dict().items()})
    module.load_state_dict(state, strict=True)
    return module


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description="Inference from a torch.export Matcha artifact")
    parser.add_argument("artifact", type=str, help=".pt2 from matcha_tpu_torch.deploy.export")
    parser.add_argument("checkpoint_path", type=str, help="checkpoint providing the weights")
    parser.add_argument("--text", type=str, default=None)
    parser.add_argument("--file", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.667)
    parser.add_argument("--speaking-rate", type=float, default=1.0)
    parser.add_argument("--output-dir", type=str, default=os.getcwd())
    parser.add_argument("--cleaner", type=str, default="english_cleaners2")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--vocoder-name", type=str, default=None,
                        choices=["hifigan_T2_v1", "hifigan_univ_v1"],
                        help="an external vocoder for a mel artifact")
    parser.add_argument("--vocoder-checkpoint-path", type=str, default=None)
    args = parser.parse_args(argv)
    if not (args.text or args.file):
        raise SystemExit("provide --text or --file")

    from matcha_tpu_torch import cli

    ep = torch.export.load(args.artifact)
    specs = artifact_inputs(ep)
    device = specs["x"].device
    module = with_weights(ep, cli.load_matcha(args.checkpoint_path, device))
    B, T_x = specs["x"].shape
    _, T_y, n_feats = specs["z"].shape

    vocoder = None
    if args.vocoder_name or args.vocoder_checkpoint_path:
        name = args.vocoder_name or "hifigan_univ_v1"
        vocoder, _ = cli.load_vocoder(
            args.vocoder_checkpoint_path or cli.get_user_data_dir() / name, device, name=name)

    if args.text:
        texts = [args.text]
    else:
        with open(args.file, encoding="utf-8") as f:
            texts = [line.strip() for line in f if line.strip()]
    os.makedirs(args.output_dir, exist_ok=True)
    processed = [cli.process_text(i, t, args.cleaner) for i, t in enumerate(texts)]
    scales = torch.tensor([args.temperature, args.speaking_rate], dtype=torch.float32,
                          device=device)

    rtfs = []
    for start in range(0, len(processed), B):
        chunk = list(range(start, min(start + B, len(processed))))
        x = np.zeros((B, T_x), np.int64)
        x_lengths = np.zeros((B,), np.int64)
        for row, idx in enumerate(chunk):
            ids = processed[idx]["x"][0][:T_x]
            x[row, :len(ids)] = ids
            x_lengths[row] = len(ids)
        gen = torch.Generator(device).manual_seed(args.seed + start)
        z = torch.randn((B, T_y, n_feats), generator=gen, device=device)

        t0 = time.perf_counter()
        with torch.no_grad():
            out, out_lengths = module(torch.from_numpy(x).to(device),
                                      torch.from_numpy(x_lengths).to(device), scales, z)
            if out.dim() == 3 and vocoder is not None:  # mel artifact + external vocoder
                wav = vocoder(out.transpose(1, 2))[..., 0]
                out, out_lengths = torch.clamp(wav, -1.0, 1.0), out_lengths * vocoder_hop(vocoder)
        out, out_lengths = out.cpu().numpy(), out_lengths.cpu().numpy()
        t = time.perf_counter() - t0

        n_rows = len(chunk)
        if out.ndim == 2:  # waveforms (B, T)
            audio_samples = int(out_lengths[:n_rows].sum())
            write_wav_outputs(out, out_lengths, chunk, args.output_dir)
        else:  # mel npy + png
            audio_samples = int(out_lengths[:n_rows].sum()) * HOP
            write_mel_outputs(out, out_lengths, chunk, args.output_dir)

        rtf = t * SAMPLE_RATE / max(audio_samples, 1)
        rtfs.append(rtf)
        print(f"[🍵-batch {start // B + 1}] {n_rows} utterances, RTF: {rtf:.4f}")

    print(f"[🍵] Average RTF: {np.mean(rtfs):.4f} ± {np.std(rtfs):.4f}")
    return rtfs


if __name__ == "__main__":
    main()
