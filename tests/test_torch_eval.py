"""The port's ``eval.py`` against the JAX package's, and its native
checkpoints at the CLI's loader.

One set of weights (the tiny config's model from
``train.build_model_from_cfg`` and a seed) is written as the port's native checkpoint and,
through the JAX package's converter, as JAX's; both ``evaluate`` run on
the same synthetic corpus. ``dur_loss`` and ``prior_loss`` use no noise
and must agree within 1e-5 (relative); ``diff_loss`` and
``mcd_vs_target`` agree within 1e-5 (relative) with JAX's noise handed
to the port (the losses' t and z from ``PRNGKey(0)`` per batch, the
synthesis's z from ``PRNGKey(1)``), never re-drawn: f32 sums in another
order through a few dozen layers.
"""

import jax
import numpy as np
import pytest
import torch

from matcha_tpu import eval as jax_eval
from matcha_tpu.utils import checkpoints as jax_ckpt
from matcha_tpu.utils import config as jax_config
from matcha_tpu_torch import cli as port_cli
from matcha_tpu_torch import eval as port_eval
from matcha_tpu_torch import train as port_train
from matcha_tpu_torch.utils.checkpoints import save_native_checkpoint
from matcha_tpu_torch.utils.config import compose
from tests.test_torch_losses import jax_noise
from tests.test_torch_train import CLEANER, corpus  # noqa: F401 (fixture)

EVAL_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch on 2 threads: the suite runs 6 workers on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def eval_overrides(corpus, ckpt_path) -> list:  # noqa: F811
    return [
        f"ckpt_path={ckpt_path}", "trainer.accelerator=cpu",
        f"data.train_filelist_path={corpus['train']}",
        f"data.valid_filelist_path={corpus['val']}", "data.batch_size=2",
        f"data.cleaners=[{CLEANER}]", "data.n_feats=16", "data.f_max=4000", "data.num_workers=0",
        "model.n_feats=16", "model.encoder.encoder_params.n_channels=16",
        "model.encoder.encoder_params.filter_channels=32",
        "model.encoder.encoder_params.filter_channels_dp=16",
        "model.encoder.encoder_params.n_layers=1", "model.decoder.channels=[16,16]",
        "model.decoder.num_mid_blocks=1", "model.decoder.num_heads=1",
        "model.decoder.attention_head_dim=16",
    ]


@pytest.fixture(scope="module")
def checkpoints(corpus, tmp_path_factory):  # noqa: F811
    """The port's and JAX's native checkpoints of one set of weights."""
    root = tmp_path_factory.mktemp("eval")
    cfg = compose("eval", eval_overrides(corpus, "unused"))
    torch.manual_seed(3)
    model = port_train.build_model_from_cfg(cfg)
    port = save_native_checkpoint(str(root / "port"), model, {"cfg": dict(cfg)})
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jax_ckpt.convert_matcha_state_dict(sd, n_down_blocks=2, num_mid_blocks=1)
    jax_path = jax_ckpt.save_native_checkpoint(str(root / "jax"), variables, {})
    return {"port": port, "jax": jax_path}


def test_evaluate_matches_jax(corpus, checkpoints):  # noqa: F811
    """The validation means and the MCD of two synthesised utterances:
    the port's ``evaluate`` on its checkpoint against JAX's on its own, with
    JAX's noise injected."""
    want = jax_eval.evaluate(jax_config.compose("eval", eval_overrides(
        corpus, checkpoints["jax"])))[0]
    cfg = compose("eval", eval_overrides(corpus, checkpoints["port"]))
    first = next(port_train.build_datamodule_from_cfg(cfg).val_batches())
    T_y, n_feats = first["y"].shape[1:]
    mcd_z = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                          (2, T_y, n_feats))))
    got = port_eval.evaluate(cfg, noise=lambda bi, batch: jax_noise(jax.random.PRNGKey(0), batch),
                             mcd_z=mcd_z)[0]
    assert sorted(got) == sorted(want) == ["diff_loss", "dur_loss", "loss", "mcd_vs_target",
                                           "prior_loss"]
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL, atol=0, err_msg=k)


def test_eval_main_on_a_native_checkpoint(corpus, checkpoints, capsys):  # noqa: F811
    """``python -m matcha_tpu_torch.eval`` (its ``main``): finite means
    printed, and no MCD with ``eval_mcd=false``; the same means with the
    noise left to its seeded generators on a second run."""
    argv = eval_overrides(corpus, checkpoints["port"])
    first = port_eval.main(argv + ["eval_mcd=false"])
    assert sorted(first) == ["diff_loss", "dur_loss", "loss", "prior_loss"]
    assert all(np.isfinite(v) for v in first.values())
    assert "dur_loss: " in capsys.readouterr().out
    assert port_eval.main(argv + ["eval_mcd=false"]) == first


def test_eval_requires_a_checkpoint_and_a_device(corpus, checkpoints, monkeypatch):  # noqa: F811
    """``ckpt_path`` left at ``???`` is refused; without a GPU and without
    ``trainer.accelerator=cpu`` eval raises instead of running on the
    CPU."""
    with pytest.raises(ValueError, match="ckpt_path"):
        port_eval.main([o for o in eval_overrides(corpus, "x") if not o.startswith("ckpt_path")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [o for o in eval_overrides(corpus, checkpoints["port"]) if "accelerator" not in o]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.main(argv)


def test_cli_loader_reads_trainer_checkpoints(corpus, checkpoints, tmp_path):  # noqa: F811
    """``load_matcha`` on a native checkpoint builds
    ``MatchaTTS(**hparams["model_kwargs"])`` as JAX's does: the trainer's
    checkpoint names none, so the default widths, whose strict load
    refuses these tiny weights naming the keys; with ``model_kwargs`` the
    same weights load, equal."""
    with pytest.raises(RuntimeError, match="size mismatch for encoder.emb.weight"):
        port_cli.load_matcha(checkpoints["port"], "cpu")
    cfg = compose("eval", eval_overrides(corpus, "unused"))
    torch.manual_seed(3)
    model = port_train.build_model_from_cfg(cfg)
    kwargs = dict(n_feats=16, enc_n_channels=16, enc_filter_channels=32,
                  enc_filter_channels_dp=16, enc_n_layers=1, dec_channels=[16, 16],
                  dec_num_mid_blocks=1, dec_num_heads=1, dec_attention_head_dim=16)
    path = save_native_checkpoint(str(tmp_path), model, {"model_kwargs": kwargs})
    loaded = port_cli.load_matcha(path, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
