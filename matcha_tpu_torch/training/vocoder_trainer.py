"""The HiFi-GAN vocoder's GAN training step: generator + MPD/MSD adversaries.

The port of ``matcha_tpu/training/vocoder_trainer.py``:

* the generator and both discriminators train in the weight-norm (g, v)
  form; the MSD's scale 0 is spectrally normalised with a running u
  (``hifigan.SNConv1d``);
* two ``torch.optim.Adam(lr, betas=(adam_b1, adam_b2), eps=1e-8)``, one for
  the generator and one for the MPD and MSD together, at the rate
  ``lr * lr_decay ** floor(step / steps_per_epoch)`` (optax's
  ``exponential_decay(staircase=True)``; constant when ``steps_per_epoch``
  is unknown); no gradient clipping;
* a step: the discriminator update first (LSGAN on the MPD and MSD, the
  generated waveform detached, scale 0's u stored), then the generator
  update against the updated discriminators and the new u (LSGAN +
  2 x feature matching + 45 x the L1 distance of the log-mels).

JAX differentiates two generator forwards (one per loss); the
generator's weights do not change between them, so the port runs one
and feeds its output, detached, to the discriminator update (upstream
HiFi-GAN's ``train.py`` does the same). The generator runs its plain
convs under autograd: the fused MRF kernel has no backward, in either
package.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from matcha_tpu_torch.audio.mel import mel_spectrogram
from matcha_tpu_torch.models.hifigan import (
    Generator,
    HiFiGANConfig,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
)

MEL_LOSS_WEIGHT = 45.0


@dataclass
class VocoderTrainState:
    """Everything a resume needs: the three models (the MSD with its
    running u), both optimisers and the update count."""

    h: HiFiGANConfig
    gen: Generator
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer
    step: int = 0
    steps_per_epoch: Optional[int] = None

    def state_dict(self) -> dict:
        return {"step": self.step, "gen": self.gen.state_dict(), "mpd": self.mpd.state_dict(),
                "msd": self.msd.state_dict(), "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict()}

    def load_state_dict(self, payload: dict) -> None:
        for name in ("gen", "mpd", "msd", "gen_opt", "disc_opt"):
            getattr(self, name).load_state_dict(payload[name])
        self.step = int(payload["step"])


def learning_rate(h: HiFiGANConfig, step: int, steps_per_epoch: Optional[int] = None) -> float:
    """The rate of update number ``step`` (0 for the first)."""
    if not steps_per_epoch:
        return h.learning_rate
    return h.learning_rate * h.lr_decay ** (step // int(steps_per_epoch))


def make_models(h: HiFiGANConfig):
    """The training forms: every conv weight-normed, the MSD's scale 0 with
    a running u."""
    return (Generator(h, weight_norm=True), MultiPeriodDiscriminator(),
            MultiScaleDiscriminator(running_u=True))


def make_vocoder_optimizers(h: HiFiGANConfig, gen, mpd, msd):
    """(generator Adam, discriminators' Adam) at ``h``'s protocol; the
    step sets each update's rate (``learning_rate``)."""
    def adam(params):
        return torch.optim.Adam(params, lr=h.learning_rate, betas=(h.adam_b1, h.adam_b2),
                                eps=1e-8)

    return adam(gen.parameters()), adam([*mpd.parameters(), *msd.parameters()])


def init_vocoder_state(h: HiFiGANConfig, device,
                       steps_per_epoch: Optional[int] = None) -> VocoderTrainState:
    """Models drawn from ``h.seed`` on ``device``, with fresh optimisers."""
    torch.manual_seed(h.seed)
    gen, mpd, msd = (m.to(device) for m in make_models(h))
    return VocoderTrainState(h, gen, mpd, msd, *make_vocoder_optimizers(h, gen, mpd, msd),
                             steps_per_epoch=steps_per_epoch)


def mel_of(h: HiFiGANConfig, wav: torch.Tensor) -> torch.Tensor:
    """Waveform (B, 1, T) -> log-mel (B, num_mels, frames), differentiable."""
    return mel_spectrogram(wav[:, 0], h.n_fft, h.num_mels, h.sampling_rate, h.hop_size,
                           h.win_size, h.fmin, h.fmax)


def vocoder_train_step(state: VocoderTrainState, batch: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """One GAN update on a batch on the models' device: ``mel`` (B,
    num_mels, frames), ``audio`` (B, 1, segment), ``mel_loss`` (B,
    num_mels, frames). Returns ``disc_loss``, ``gen_loss`` and ``mel_l1``
    (the weighted term) as 0-d tensors on the device."""
    h = state.h
    lr = learning_rate(h, state.step, state.steps_per_epoch)
    for opt in (state.gen_opt, state.disc_opt):
        for group in opt.param_groups:
            group["lr"] = lr
    for m in (state.gen, state.mpd, state.msd):
        m.train()
    y = batch["audio"]
    y_hat = state.gen.generate(batch["mel"])

    # the discriminators' update; scale 0's running u is stored here
    y_df_r, y_df_g, _, _ = state.mpd(y, y_hat.detach())
    loss_f, _, _ = discriminator_loss(y_df_r, y_df_g)
    y_ds_r, y_ds_g, _, _ = state.msd(y, y_hat.detach(), update_u=True)
    loss_s, _, _ = discriminator_loss(y_ds_r, y_ds_g)
    d_loss = loss_f + loss_s
    state.disc_opt.zero_grad(set_to_none=True)
    d_loss.backward()
    state.disc_opt.step()

    # the generator's, against the updated discriminators and u
    mel_l1 = torch.mean(torch.abs(mel_of(h, y_hat) - batch["mel_loss"])) * MEL_LOSS_WEIGHT
    _, y_df_g, fmap_f_r, fmap_f_g = state.mpd(y, y_hat)
    _, y_ds_g, fmap_s_r, fmap_s_g = state.msd(y, y_hat)
    loss_gen_f, _ = generator_loss(y_df_g)
    loss_gen_s, _ = generator_loss(y_ds_g)
    g_loss = (loss_gen_f + loss_gen_s + feature_loss(fmap_f_r, fmap_f_g)
              + feature_loss(fmap_s_r, fmap_s_g) + mel_l1)
    gen_params = list(state.gen.parameters())
    state.gen_opt.zero_grad(set_to_none=True)
    g_loss.backward(inputs=gen_params)
    state.gen_opt.step()
    state.step += 1
    return {"disc_loss": d_loss.detach(), "gen_loss": g_loss.detach(),
            "mel_l1": mel_l1.detach()}
