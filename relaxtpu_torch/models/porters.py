"""Carry weights from the JAX package's variable trees into the port.

Inverse of ``relaxtpu/models/porters.py:46-108`` and
``relaxtpu/models/vgg.py:69-87``: the trees hold numpy (or
array-like) leaves in Flax layouts, and the functions return torch state
dicts with torchvision / DINO / reference-MLP key names.  Flax conv kernels
are (kH, kW, I, O) and become torch (O, I, kH, kW); Dense kernels (I, O)
become Linear weights (O, I); BatchNorm scale/bias and batch_stats
mean/var become weight/bias and running_mean/running_var.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from relaxtpu_torch.models.vgg import VGG_CONV_INDICES


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _linear(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).T)


def _bn(sd: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])


def resnet50_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{'params', 'batch_stats'}`` of ``relaxtpu.models.ResNet50`` ->
    torchvision-named state dict of ``models.resnet.ResNet50``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {"conv1.weight": _conv(params["conv1"]["kernel"])}
    _bn(sd, "bn1", params["bn1"], stats["bn1"])
    for si, nblocks in enumerate((3, 4, 6, 3), start=1):
        for bi in range(nblocks):
            fp, fs, tp = params[f"layer{si}_{bi}"], stats[f"layer{si}_{bi}"], f"layer{si}.{bi}"
            for ci in (1, 2, 3):
                sd[f"{tp}.conv{ci}.weight"] = _conv(fp[f"conv{ci}"]["kernel"])
                _bn(sd, f"{tp}.bn{ci}", fp[f"bn{ci}"], fs[f"bn{ci}"])
            if "downsample_conv" in fp:
                sd[f"{tp}.downsample.0.weight"] = _conv(fp["downsample_conv"]["kernel"])
                _bn(sd, f"{tp}.downsample.1", fp["downsample_bn"], fs["downsample_bn"])
    return sd


def vit_from_jax(params: Mapping[str, Any], depth: int = 12) -> dict[str, torch.Tensor]:
    """``params`` of ``relaxtpu.models.ViT`` -> DINO-named state dict."""
    if "params" in params:
        params = params["params"]
    sd = {
        "cls_token": _t(params["cls_token"]),
        "pos_embed": _t(params["pos_embed"]),
        "patch_embed.proj.weight": _conv(params["patch_embed"]["kernel"]),
        "patch_embed.proj.bias": _t(params["patch_embed"]["bias"]),
        "norm.weight": _t(params["norm"]["scale"]),
        "norm.bias": _t(params["norm"]["bias"]),
    }
    for i in range(depth):
        bp, tp = params[f"block{i}"], f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{tp}.{n}.weight"] = _t(bp[n]["scale"])
            sd[f"{tp}.{n}.bias"] = _t(bp[n]["bias"])
        for src, dst in (
            (bp["attn"]["qkv"], "attn.qkv"),
            (bp["attn"]["proj"], "attn.proj"),
            (bp["mlp_fc1"], "mlp.fc1"),
            (bp["mlp_fc2"], "mlp.fc2"),
        ):
            sd[f"{tp}.{dst}.weight"] = _linear(src["kernel"])
            sd[f"{tp}.{dst}.bias"] = _t(src["bias"])
    return sd


def vgg16_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``params`` of ``relaxtpu.models.vgg.VGG16`` -> torchvision-named
    state dict of ``models.vgg.VGG16``.  The JAX model flattens in torch's
    (C, H, W) order, so ``classifier_0`` needs only the transpose."""
    params = variables.get("params", variables)
    sd = {}
    for prefix, kernel, idxs in (("features", _conv, VGG_CONV_INDICES), ("classifier", _linear, (0, 3))):
        for idx in idxs:
            p = params[f"{prefix}_{idx}"]
            sd[f"{prefix}.{idx}.weight"] = kernel(p["kernel"])
            sd[f"{prefix}.{idx}.bias"] = _t(p["bias"])
    return sd


def mlp_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{'params', 'batch_stats'}`` of ``relaxtpu.model.mlp.Mlp`` ->
    reference-named state dict of ``model.mlp.Mlp``."""
    params = variables["params"]
    sd = {}
    for name in ("fc1", "fc2", "fc3"):
        sd[f"{name}.weight"] = _linear(params[name]["kernel"])
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    if "bn1" in params:
        _bn(sd, "bn1", params["bn1"], variables["batch_stats"]["bn1"])
    return sd
