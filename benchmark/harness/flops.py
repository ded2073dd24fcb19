"""Operations and bytes of the work a window did, from shapes, and the
card's published peaks.

- K1 (``mrf_stage_kernel``), one fused HiFi-GAN MRF stage of width C over
  T frames: 3 ResBlocks of kernels 3, 7, 11, each 3 dilations x 2 convs of
  C -> C, so 2 * C^2 * k FLOPs per output frame and conv, 252 * C^2 * T in
  all. Bytes: the stage's input and output once (f32), and its 18 convs'
  weights and biases once.
- The model (``mfu``): what ``torch.utils.flop_counter`` counts in the
  reference's encoder at T_x ids, its U-Net at T_y frames (once per
  Euler step) and its vocoder's ``generate`` at T_y mel frames (the
  reference generator of the configuration's ``vocoder_arch``, from
  ``vocoders.adapter``), run on the meta device (shapes only). The
  denoiser's FFTs are not counted: the flop counter has no formula for
  them, and they are a small part of the work.
  Attention makes each count a quadratic in the length, so each is
  counted at three lengths and the quadratic through them is evaluated.
"""

import numpy as np
import torch

#: NVIDIA H100 SXM, dense, at its full 700 W: TF32 on the tensor cores (the
#: fastest rate at which the card computes a product at the precision
#: these configurations state: f32 weights, TF32 or better) and HBM3
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_PER_S = 3.35e12

K1_KERNEL_SIZES = (3, 7, 11)
K1_CONVS_PER_KERNEL = 6  # 3 dilations x 2 convs


def k1_flops(C: int, T: int) -> float:
    return 2.0 * C * C * sum(K1_KERNEL_SIZES) * K1_CONVS_PER_KERNEL * T


def k1_bytes(C: int, T: int) -> float:
    weights = K1_CONVS_PER_KERNEL * sum(C * C * k + C for k in K1_KERNEL_SIZES)
    return 4.0 * (2 * C * T + weights)


def k1_least_s(C: int, T: int) -> float:
    """The least time one launch over T frames (summed over its rows) can
    take on the card: compute- or bandwidth-bound, whichever is longer."""
    return max(k1_flops(C, T) / PEAK_TF32_FLOPS, k1_bytes(C, T) / PEAK_HBM_BYTES_PER_S)


def k1_stages(vocoder_cfg: dict, max_fused_channels: int = 64) -> list:
    """[(C, frames per mel frame)] of the MRF stages the system runs
    through K1: those of width at most ``max_fused_channels``."""
    out, up = [], 1
    for i, u in enumerate(vocoder_cfg["upsample_rates"]):
        up *= u
        C = vocoder_cfg["upsample_initial_channel"] // 2 ** (i + 1)
        if C <= max_fused_channels:
            out.append((C, up))
    return out


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


class ModelFlops:
    """FLOPs of one utterance through the reference at its true lengths."""

    def __init__(self, cfg: dict):
        from benchmark.harness.models import _model_kwargs
        from benchmark.harness.vocoders import adapter
        from benchmark.reference.models.matcha import MatchaTTS

        with torch.device("meta"):
            self.model = MatchaTTS(**_model_kwargs(cfg)).eval()
        self.vocoder = adapter(cfg).reference(cfg["vocoder"], "meta").eval()
        self.n_feats = cfg["model"]["n_feats"]
        self.n_spks = cfg["model"]["n_spks"]
        self.steps = cfg["synthesis"]["n_timesteps"]
        self._fits = {}

    def _spk(self):
        if self.n_spks <= 1:
            return None
        return self.model.spk_emb(torch.zeros((1,), dtype=torch.long, device="meta"))

    def encoder_at(self, n: int) -> int:
        x = torch.zeros((1, n), dtype=torch.long, device="meta")
        mask = torch.ones((1, n, 1), device="meta")
        with torch.no_grad():
            return _count(lambda: self.model.encoder(x, mask, self._spk()))

    def estimator_at(self, T: int) -> int:
        x = torch.zeros((1, T, self.n_feats), device="meta")
        mask = torch.ones((1, T, 1), device="meta")
        t = torch.zeros((), device="meta")
        with torch.no_grad():
            return _count(lambda: self.model.decoder.estimator(x, mask, x, t, self._spk()))

    def vocoder_at(self, T: int) -> int:
        mel = torch.zeros((1, self.n_feats, T), device="meta")
        with torch.no_grad():
            return _count(lambda: self.vocoder.generate(mel))

    def _fit(self, name: str, at, points):
        if name not in self._fits:
            ys = [at(p) for p in points]
            self._fits[name] = np.polyfit(np.asarray(points, np.float64), np.asarray(ys, np.float64), 2)
        return self._fits[name]

    def utterance(self, n_ids: int, n_frames: int) -> float:
        enc = np.polyval(self._fit("enc", self.encoder_at, (64, 128, 256)), n_ids)
        est = np.polyval(self._fit("est", self.estimator_at, (128, 256, 512)), n_frames)
        voc = np.polyval(self._fit("voc", self.vocoder_at, (32, 64, 128)), n_frames)
        return float(enc + self.steps * est + voc)
