"""Weight bridge of the PyTorch port (matcha_tpu_torch.convert).

A reference-layout torch state dict goes through the JAX package's
converter (torch -> flax) and back through the port's bridge (flax ->
torch); the result must be the original tensors, bit for bit, because
every step is a transpose/flip. HiFi-GAN comes back folded, so it is held
against the JAX package's own weight-norm fold.
"""

import numpy as np
import pytest
import torch

from matcha_tpu.utils.checkpoints import (
    convert_hifigan_state_dict,
    convert_matcha_state_dict,
    fold_weight_norm,
)
from matcha_tpu_torch.convert import (
    fold_hifigan_state_dict,
    hifigan_state_dict,
    matcha_state_dict,
)
from matcha_tpu_torch.models.hifigan import Generator
from matcha_tpu_torch.models.hifigan import HiFiGANConfig as PortHiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaTTS
from tests.test_convert import (
    TINY,
    TINY_HIFI,
    synthetic_hifigan_state_dict,
    synthetic_matcha_state_dict,
)


def _port_hifi_config(h):
    return PortHiFiGANConfig(
        upsample_rates=h.upsample_rates, upsample_kernel_sizes=h.upsample_kernel_sizes,
        upsample_initial_channel=h.upsample_initial_channel,
        resblock_kernel_sizes=h.resblock_kernel_sizes,
        resblock_dilation_sizes=h.resblock_dilation_sizes, num_mels=h.num_mels)


def test_matcha_bridge_round_trip_is_exact(rng):
    sd = synthetic_matcha_state_dict(rng)
    flax_params = convert_matcha_state_dict(sd, n_down_blocks=2,
                                            num_mid_blocks=TINY["dec_num_mid_blocks"])
    back = matcha_state_dict(flax_params, n_down_blocks=2,
                             num_mid_blocks=TINY["dec_num_mid_blocks"],
                             mel_mean=float(sd["mel_mean"]), mel_std=float(sd["mel_std"]))
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert back[key].shape == value.shape, key
        assert torch.equal(back[key], value), key
    # the port's model takes the bridged dict as it is
    MatchaTTS(**TINY).load_state_dict(back)


def test_hifigan_bridge_gives_the_folded_reference_weights(rng):
    sd = synthetic_hifigan_state_dict(rng)
    back = hifigan_state_dict(convert_hifigan_state_dict(sd))
    expected = {}
    for key, value in sd.items():
        if key.endswith(".weight_g"):
            stem = key[: -len(".weight_g")]
            expected[f"{stem}.weight"] = fold_weight_norm(value.numpy(), sd[f"{stem}.weight_v"].numpy())
        elif key.endswith(".bias"):
            expected[key] = value.numpy()
    assert set(back) == set(expected)
    for key, value in expected.items():
        # transposes and the conv-transpose flip only: exact
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)
    Generator(_port_hifi_config(TINY_HIFI)).load_state_dict(back)


@pytest.mark.parametrize("naming", ["weight_g", "parametrizations"])
def test_port_fold_matches_jax_fold(rng, naming):
    sd = synthetic_hifigan_state_dict(rng)
    if naming == "parametrizations":  # torch >= 2.1 parametrized names
        renamed = {}
        for key, value in sd.items():
            key = key.replace(".weight_g", ".parametrizations.weight.original0")
            key = key.replace(".weight_v", ".parametrizations.weight.original1")
            renamed[key] = value
        sd_in = renamed
    else:
        sd_in = sd
    folded = fold_hifigan_state_dict(sd_in)
    want = hifigan_state_dict(convert_hifigan_state_dict(sd))
    assert set(folded) == set(want)
    for key in want:
        # the same formula in torch and numpy: f32 rounding only
        np.testing.assert_allclose(folded[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
