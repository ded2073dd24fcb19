"""The port's numpy mel frontend against the JAX package's, and the choice of frontend.

``matcha_tpu_torch/audio/mel.py`` is a copy of the numpy pipeline of
``matcha_tpu/audio/mel.py``; on the same audio the filterbank, the window
and the log-mel must be EQUAL (same numpy calls in the same order).
"""

import numpy as np
import pytest

from matcha_tpu.audio import mel as jax_mel
from matcha_tpu_torch.audio import mel as port_mel


@pytest.mark.parametrize("n_samples,n_mels,fmax", [(22050, 80, 8000.0), (5000, 16, 4000.0),
                                                   (1024, 80, None)])
def test_mel_equals_jax_package(n_samples, n_mels, fmax):
    rng = np.random.default_rng(n_samples)
    t = np.arange(n_samples) / 22050
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(size=n_samples))
    audio = audio.astype(np.float32)
    np.testing.assert_array_equal(port_mel.mel_filterbank(22050, 1024, n_mels, 0.0, fmax),
                                  jax_mel.mel_filterbank(22050, 1024, n_mels, 0.0, fmax))
    np.testing.assert_array_equal(port_mel.hann_window_periodic(1024),
                                  jax_mel.hann_window_periodic(1024))
    got = port_mel.mel_spectrogram_np(audio, num_mels=n_mels, fmax=fmax)
    want = jax_mel.mel_spectrogram_np(audio, num_mels=n_mels, fmax=fmax)
    assert got.shape == want.shape == (n_mels, n_samples // 256)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_mel_frontends():
    from matcha_tpu_torch.audio.native import mel_spectrogram_native

    assert port_mel.resolve_mel_frontend("numpy") is port_mel.mel_spectrogram_np
    # as the JAX package: "auto" takes the native frontend when it builds
    assert port_mel.resolve_mel_frontend("auto") is mel_spectrogram_native
    assert port_mel.resolve_mel_frontend("native") is mel_spectrogram_native
    with pytest.raises(ValueError, match="unknown mel frontend"):
        port_mel.resolve_mel_frontend("librosa")
    with pytest.raises(ValueError, match="center"):
        port_mel.mel_spectrogram_np(np.zeros(2048, np.float32), center=True)
