"""ResNet-50 with multi-layer activation taps, NCHW.

Counterpart of ``relaxtpu/models/resnet.py:34-137``: torchvision layout and
parameter names (so torchvision checkpoints load as they are), one forward
that returns the 15 tap channel means in f32 plus the global average pool.
The ``conv1`` tap is the raw conv output, before BN (a hook on the conv
module sees it there).
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn

from relaxtpu_torch.device import upload
from relaxtpu_torch.utils.keywords import jax_keywords

RESNET_TAPS = (
    "conv1",
    "layer1.0", "layer1.1", "layer1.2",
    "layer2.0", "layer2.1", "layer2.2", "layer2.3",
    "layer3.0", "layer3.1", "layer3.2", "layer3.3",
    "layer4.0", "layer4.1", "layer4.2",
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))


@functools.lru_cache(maxsize=8)
def _imagenet_stats(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(2, 3, 1, 1) mean and std, copied to the device once without blocking."""
    return upload(torch.tensor([IMAGENET_MEAN, IMAGENET_STD], dtype=dtype)[..., None, None], device)


@jax_keywords(img_rgb_f01="rgb01")
def resnet_preprocess(rgb01: torch.Tensor) -> torch.Tensor:
    """ImageNet normalisation of (B, 3, H, W) RGB in [0, 1]."""
    mean, std = _imagenet_stats(rgb01.dtype, rgb01.device)
    return (rgb01 - mean) / std


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4), post-add ReLU."""

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        cout = width * 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout)
            )

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + idt)


class ResNet50(nn.Module):
    """Multi-tap ResNet-50.  forward((B, 3, 224, 224) preprocessed) returns
    {tap: (B, C) f32 channel mean} for RESNET_TAPS and 'avgpool' (B, 2048)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for si, (blocks, width, stride) in enumerate(_STAGES, start=1):
            layer = [
                Bottleneck(cin if bi == 0 else width * 4, width, stride if bi == 0 else 1)
                for bi in range(blocks)
            ]
            cin = width * 4
            setattr(self, f"layer{si}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        taps = {}
        y = self.conv1(x)
        taps["conv1"] = y.float().mean(dim=(2, 3))
        y = self.maxpool(self.relu(self.bn1(y)))
        for si in range(1, 5):
            for bi, blk in enumerate(getattr(self, f"layer{si}")):
                y = blk(y)
                name = f"layer{si}.{bi}"
                if name in RESNET_TAPS:
                    taps[name] = y.float().mean(dim=(2, 3))
        taps["avgpool"] = y.float().mean(dim=(2, 3))
        return taps
