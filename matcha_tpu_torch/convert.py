"""Weight bridge: JAX (flax) param trees -> reference-layout torch state dicts.

The inverse of ``matcha_tpu/utils/checkpoints.py`` (its layout helpers,
``convert_matcha_state_dict`` and ``convert_hifigan_state_dict``): the
returned state dicts carry the reference torch names and layouts, so the
port's ``MatchaTTS`` and ``Generator`` load them with ``load_state_dict``,
exactly as they load a reference checkpoint. HiFi-GAN comes out folded
(weight norm removed) from ``hifigan_state_dict``, and in its (g, v)
training form from ``hifigan_wn_state_dict``; the discriminators of
vocoder training from ``mpd_state_dict`` and ``msd_state_dict`` (the
reference's ``discriminators.{i}.convs.{j}.*`` names, which
``matcha_tpu/utils/checkpoints.py`` reads). Leaves are numpy arrays (or
anything ``np.asarray`` takes); nothing here imports JAX.

Layouts (flax -> torch):
* conv kernel (k, in, out)          -> Conv1d weight (out, in, k)
* dense kernel (in, out)            -> Linear (out, in), or (out, in, 1) for a 1x1 Conv1d
* conv-transpose kernel (k, in, out), flipped along k
                                    -> ConvTranspose1d weight (in, out, k), un-flipped
* grouped (depthwise) conv kernel (k, 1, C) -> Conv1d weight (C, 1, k)
* 2-D conv kernel (kh, kw, in, out)  -> Conv2d weight (out, in, kh, kw)
* weight-norm g (n,)                 -> weight_g (n, 1, ...), n the first dim of weight_v
"""

from typing import Dict, Optional

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def conv1d_weight(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (2, 1, 0)))


def linear_weight(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).T)


def pointwise_conv_weight(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).T[:, :, None])


def conv_transpose1d_weight(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel)[::-1], (1, 2, 0)))


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """weight_norm(dim=0): w = g * v / ||v||, the norm over all non-output
    dims."""
    norm = torch.sqrt(torch.sum(v ** 2, dim=tuple(range(1, v.dim())), keepdim=True))
    return g * v / norm


def matcha_state_dict(params: dict, n_down_blocks: int = 2, num_mid_blocks: int = 2,
                      mel_mean: float = 0.0, mel_std: float = 1.0) -> Dict[str, torch.Tensor]:
    """Flax ``MatchaTTS`` variables (the ``params`` collection, and
    ``batch_stats`` for conformer blocks in BatchNorm mode) -> reference
    torch state dict, ``mel_mean``/``mel_std`` included. Conformer blocks
    come out in the lucidrains layout (``ff1.fn.norm``, ``attn.fn.to_kv``,
    ``conv.net.5.running_mean``, ...)."""
    p = params["params"] if "params" in params else params
    stats = params.get("batch_stats", {}).get("decoder", {})
    sd: Dict[str, torch.Tensor] = {
        "mel_mean": torch.tensor(float(mel_mean)), "mel_std": torch.tensor(float(mel_std))}

    def conv(node, prefix):
        sd[f"{prefix}.weight"] = conv1d_weight(node["conv"]["kernel"])
        if "bias" in node["conv"]:
            sd[f"{prefix}.bias"] = _t(node["conv"]["bias"])

    def pointwise(node, prefix):
        sd[f"{prefix}.weight"] = pointwise_conv_weight(node["kernel"])
        sd[f"{prefix}.bias"] = _t(node["bias"])

    def linear(node, prefix, bias=True):
        sd[f"{prefix}.weight"] = linear_weight(node["kernel"])
        if bias:
            sd[f"{prefix}.bias"] = _t(node["bias"])

    def channel_norm(node, prefix):
        sd[f"{prefix}.gamma"] = _t(node["gamma"])
        sd[f"{prefix}.beta"] = _t(node["beta"])

    def norm(node, prefix):
        sd[f"{prefix}.weight"] = _t(node["scale"])
        sd[f"{prefix}.bias"] = _t(node["bias"])

    enc = p["encoder"]
    sd["encoder.emb.weight"] = _t(enc["emb"]["embedding"])
    if "spk_emb" in p:
        sd["spk_emb.weight"] = _t(p["spk_emb"]["embedding"])
    if "prenet" in enc:
        layers = sorted(int(k.rsplit("_", 1)[1]) for k in enc["prenet"] if k.startswith("conv_layers_"))
        for i in layers:
            conv(enc["prenet"][f"conv_layers_{i}"], f"encoder.prenet.conv_layers.{i}")
            channel_norm(enc["prenet"][f"norm_layers_{i}"], f"encoder.prenet.norm_layers.{i}")
        pointwise(enc["prenet"]["proj"], "encoder.prenet.proj")
    layers = sorted(int(k.rsplit("_", 1)[1]) for k in enc["encoder"] if k.startswith("attn_layers_"))
    for i in layers:
        e = enc["encoder"]
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            pointwise(e[f"attn_layers_{i}"][name], f"encoder.encoder.attn_layers.{i}.{name}")
        channel_norm(e[f"norm_layers_1_{i}"], f"encoder.encoder.norm_layers_1.{i}")
        conv(e[f"ffn_layers_{i}"]["conv_1"], f"encoder.encoder.ffn_layers.{i}.conv_1")
        conv(e[f"ffn_layers_{i}"]["conv_2"], f"encoder.encoder.ffn_layers.{i}.conv_2")
        channel_norm(e[f"norm_layers_2_{i}"], f"encoder.encoder.norm_layers_2.{i}")
    pointwise(enc["proj_m"], "encoder.proj_m")
    pw = enc["proj_w"]
    conv(pw["conv_1"], "encoder.proj_w.conv_1")
    channel_norm(pw["norm_1"], "encoder.proj_w.norm_1")
    conv(pw["conv_2"], "encoder.proj_w.conv_2")
    channel_norm(pw["norm_2"], "encoder.proj_w.norm_2")
    pointwise(pw["proj"], "encoder.proj_w.proj")

    dec = p["decoder"]
    est = "decoder.estimator"
    linear(dec["time_mlp"]["linear_1"], f"{est}.time_mlp.linear_1")
    linear(dec["time_mlp"]["linear_2"], f"{est}.time_mlp.linear_2")

    def resnet(node, prefix):
        conv(node["block1"]["conv"], f"{prefix}.block1.block.0")
        norm(node["block1"]["norm"], f"{prefix}.block1.block.1")
        conv(node["block2"]["conv"], f"{prefix}.block2.block.0")
        norm(node["block2"]["norm"], f"{prefix}.block2.block.1")
        linear(node["mlp"], f"{prefix}.mlp.1")
        pointwise(node["res_conv"], f"{prefix}.res_conv")

    def tblocks(path_prefix, prefix):
        js = sorted(int(k.rsplit("_", 1)[1]) for k in dec
                    if k.startswith(f"{path_prefix}_transformer_"))
        for j in js:
            node, pre = dec[f"{path_prefix}_transformer_{j}"], f"{prefix}.{j}"
            norm(node["norm1"], f"{pre}.norm1")
            for name in ("to_q", "to_k", "to_v"):
                linear(node["attn1"][name], f"{pre}.attn1.{name}", bias=False)
            linear(node["attn1"]["to_out"], f"{pre}.attn1.to_out.0")
            norm(node["norm3"], f"{pre}.norm3")
            act = node["ff"]["act"]
            linear(act["proj"], f"{pre}.ff.net.0.proj")
            if "alpha" in act:
                sd[f"{pre}.ff.net.0.alpha"] = _t(act["alpha"])
                sd[f"{pre}.ff.net.0.beta"] = _t(act["beta"])
            linear(node["ff"]["proj_out"], f"{pre}.ff.net.2")
        js = sorted(int(k.rsplit("_", 1)[1]) for k in dec
                    if k.startswith(f"{path_prefix}_conformer_"))
        for j in js:
            name = f"{path_prefix}_conformer_{j}"
            block = conformer_state_dict(dec[name], stats.get(name))
            sd.update({f"{prefix}.{j}.{k}": v for k, v in block.items()})

    for i in range(n_down_blocks):
        resnet(dec[f"down_{i}_resnet"], f"{est}.down_blocks.{i}.0")
        tblocks(f"down_{i}", f"{est}.down_blocks.{i}.1")
        if i == n_down_blocks - 1:  # a bare Conv1d
            conv(dec[f"down_{i}_downsample"], f"{est}.down_blocks.{i}.2")
        else:  # Downsample1D wrapping a Conv1d
            conv(dec[f"down_{i}_downsample"]["conv"], f"{est}.down_blocks.{i}.2.conv")
    for i in range(num_mid_blocks):
        resnet(dec[f"mid_{i}_resnet"], f"{est}.mid_blocks.{i}.0")
        tblocks(f"mid_{i}", f"{est}.mid_blocks.{i}.1")
    for i in range(n_down_blocks):
        resnet(dec[f"up_{i}_resnet"], f"{est}.up_blocks.{i}.0")
        tblocks(f"up_{i}", f"{est}.up_blocks.{i}.1")
        if i == n_down_blocks - 1:
            conv(dec[f"up_{i}_upsample"], f"{est}.up_blocks.{i}.2")
        else:
            node = dec[f"up_{i}_upsample"]["conv"]
            sd[f"{est}.up_blocks.{i}.2.conv.weight"] = conv_transpose1d_weight(node["kernel"])
            sd[f"{est}.up_blocks.{i}.2.conv.bias"] = _t(node["bias"])
    conv(dec["final_block"]["conv"], f"{est}.final_block.block.0")
    norm(dec["final_block"]["norm"], f"{est}.final_block.block.1")
    pointwise(dec["final_proj"], f"{est}.final_proj")
    return sd


def conformer_state_dict(params: dict, batch_stats: Optional[dict] = None
                         ) -> Dict[str, torch.Tensor]:
    """A flax ``ConformerBlock``'s params (and, in BatchNorm mode, its
    ``batch_stats``) -> the lucidrains torch keys of one block, the
    inverse of ``matcha_tpu/utils/checkpoints.py::_convert_conformer_block``."""
    sd: Dict[str, torch.Tensor] = {}

    def linear(node, prefix, bias=True):
        sd[f"{prefix}.weight"] = linear_weight(node["kernel"])
        if bias:
            sd[f"{prefix}.bias"] = _t(node["bias"])

    def norm(node, prefix):
        sd[f"{prefix}.weight"] = _t(node["scale"])
        sd[f"{prefix}.bias"] = _t(node["bias"])

    for ff in ("ff1", "ff2"):
        norm(params[ff]["norm"], f"{ff}.fn.norm")
        linear(params[ff]["ff1"], f"{ff}.fn.fn.net.0")
        linear(params[ff]["ff2"], f"{ff}.fn.fn.net.3")
    attn = params["attn"]
    norm(attn["norm"], "attn.norm")
    linear(attn["to_q"], "attn.fn.to_q", bias=False)
    linear(attn["to_kv"], "attn.fn.to_kv", bias=False)
    linear(attn["to_out"], "attn.fn.to_out")
    sd["attn.fn.rel_pos_emb.weight"] = _t(attn["rel_pos_emb"]["embedding"])
    cm = params["conv"]
    norm(cm["norm"], "conv.net.0")
    # the pointwise convs are flax Dense layers: (in, out) -> (out, in, 1)
    sd["conv.net.2.weight"] = pointwise_conv_weight(cm["pw1"]["kernel"])
    sd["conv.net.2.bias"] = _t(cm["pw1"]["bias"])
    sd["conv.net.4.conv.weight"] = conv1d_weight(cm["depthwise"]["kernel"])
    sd["conv.net.4.conv.bias"] = _t(cm["depthwise"]["bias"])
    norm(cm["bn"], "conv.net.5")
    if batch_stats:  # BatchNorm mode: its running statistics
        sd["conv.net.5.running_mean"] = _t(batch_stats["conv"]["bn"]["mean"])
        sd["conv.net.5.running_var"] = _t(batch_stats["conv"]["bn"]["var"])
        sd["conv.net.5.num_batches_tracked"] = torch.tensor(0)
    sd["conv.net.7.weight"] = pointwise_conv_weight(cm["pw2"]["kernel"])
    sd["conv.net.7.bias"] = _t(cm["pw2"]["bias"])
    norm(params["post_norm"], "post_norm")
    return sd


def hifigan_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """Folded flax HiFi-GAN ``Generator`` params -> reference torch state
    dict with plain (weight-norm-removed) ``weight``/``bias`` keys."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for name, node in p.items():
        if name in ("conv_pre", "conv_post"):
            sd[f"{name}.weight"] = conv1d_weight(node["conv"]["kernel"])
            sd[f"{name}.bias"] = _t(node["conv"]["bias"])
        elif name.startswith("ups_"):
            i = name.split("_")[1]
            sd[f"ups.{i}.weight"] = conv_transpose1d_weight(node["kernel"])
            sd[f"ups.{i}.bias"] = _t(node["bias"])
        elif name.startswith("resblocks_"):
            n = name.split("_")[1]
            for conv_name, conv_node in node.items():
                group, j = conv_name.rsplit("_", 1)
                sd[f"resblocks.{n}.{group}.{j}.weight"] = conv1d_weight(conv_node["conv"]["kernel"])
                sd[f"resblocks.{n}.{group}.{j}.bias"] = _t(conv_node["conv"]["bias"])
        else:
            raise KeyError(f"unknown HiFi-GAN param group {name!r}")
    return sd


def fold_hifigan_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference (weight-normed) generator state dict -> folded
    ``weight``/``bias`` keys. Handles both the ``weight_g``/``weight_v``
    and the ``parametrizations.weight.original0/1`` namings; plain
    ``weight`` keys pass through."""
    out = {}
    for key, value in sd.items():
        if key.endswith(".weight_g") or key.endswith(".parametrizations.weight.original0"):
            stem = key.rsplit(".weight_g", 1)[0] if key.endswith(".weight_g") \
                else key.rsplit(".parametrizations", 1)[0]
            v = sd[f"{stem}.weight_v"] if key.endswith(".weight_g") \
                else sd[f"{stem}.parametrizations.weight.original1"]
            out[f"{stem}.weight"] = fold_weight_norm(value.float(), v.float())
        elif key.endswith(".weight_v") or key.endswith(".parametrizations.weight.original1"):
            continue
        else:
            out[key] = value.float()
    return out


def _wn(node, v_layout) -> Dict[str, torch.Tensor]:
    """A flax weight-norm node {weight_v, weight_g, bias} -> torch's
    ``weight_v`` (``v_layout`` of the flax kernel), ``weight_g`` (shaped
    (n, 1, ...) like ``weight_v``) and ``bias``."""
    v = v_layout(node["weight_v"])
    g = _t(node["weight_g"]).reshape(-1, *([1] * (v.dim() - 1)))
    return {"weight_v": v, "weight_g": g, "bias": _t(node["bias"])}


def hifigan_wn_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """Flax ``Generator(weight_norm=True)`` params -> the state dict of the
    port's ``Generator(weight_norm=True)`` (the reference's ``weight_g``/
    ``weight_v``/``bias`` keys). Fold it for serving with
    :func:`fold_hifigan_state_dict`."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix, node, layout=conv1d_weight):
        sd.update({f"{prefix}.{k}": v for k, v in _wn(node, layout).items()})

    for name, node in p.items():
        if name in ("conv_pre", "conv_post"):
            put(name, node)
        elif name.startswith("ups_"):
            put(f"ups.{name.split('_')[1]}", node, conv_transpose1d_weight)
        elif name.startswith("resblocks_"):
            n = name.split("_")[1]
            for conv_name, conv_node in node.items():
                group, j = conv_name.rsplit("_", 1)
                put(f"resblocks.{n}.{group}.{j}", conv_node)
        else:
            raise KeyError(f"unknown HiFi-GAN param group {name!r}")
    return sd


def conv2d_weight(kernel) -> torch.Tensor:
    """flax HWIO (kh, kw, in, out) -> torch Conv2d (out, in, kh, kw)."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _wn_discriminator_convs(node, prefix: str, layout, sd: dict) -> None:
    """The weight-normed ``convs_j`` and ``conv_post`` of one flax
    discriminator -> torch keys under ``prefix``."""
    for name, conv in node.items():
        key = f"{prefix}.convs.{name.split('_')[1]}" if name.startswith("convs_") \
            else f"{prefix}.{name}"
        sd.update({f"{key}.{k}": v for k, v in _wn(conv, layout).items()})


def mpd_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """Flax ``MultiPeriodDiscriminator(weight_norm=True)`` params -> the
    port's state dict: ``discriminators.{i}.convs.{j}.weight_g|weight_v|
    bias``, as the reference names them."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for name, node in p.items():
        _wn_discriminator_convs(node, f"discriminators.{name.split('_')[1]}", conv2d_weight, sd)
    return sd


def msd_state_dict(params: dict, spectral: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Flax ``MultiScaleDiscriminator(weight_norm=True)`` params, and its ``"spectral"``
    collection when it ran with ``running_u``, -> the port's state dict.
    Scale 0 is spectrally normalised: its flax ``kernel`` becomes
    ``weight_orig`` and its running u ``weight_u``, with ``weight_v`` the
    normalised Wᵀu that u gives (torch ``spectral_norm``'s names); without
    a u it starts at 1 / sqrt(out), as JAX's. Scales 1 and 2 as
    :func:`mpd_state_dict`'s convs."""
    p = params["params"] if "params" in params else params
    spectral = (spectral or {}).get("spectral", spectral or {})
    sd: Dict[str, torch.Tensor] = {}
    for name, node in p.items():
        i = name.split("_")[1]
        if i != "0":
            _wn_discriminator_convs(node, f"discriminators.{i}", conv1d_weight, sd)
            continue
        for conv_name, conv in node.items():
            key = (f"discriminators.0.convs.{conv_name.split('_')[1]}"
                   if conv_name.startswith("convs_") else f"discriminators.0.{conv_name}")
            w = conv1d_weight(conv["kernel"])
            out = w.shape[0]
            u_node = spectral.get(name, {}).get(conv_name)
            u = (_t(u_node["u"]) if u_node is not None
                 else torch.ones(out) / torch.sqrt(torch.tensor(float(out))))
            v = w.reshape(out, -1).t() @ u
            sd[f"{key}.weight_orig"] = w
            sd[f"{key}.bias"] = _t(conv["bias"])
            sd[f"{key}.weight_u"] = u
            sd[f"{key}.weight_v"] = v / (torch.linalg.vector_norm(v) + 1e-12)
    return sd
