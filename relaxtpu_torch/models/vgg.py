"""VGG-16 with conv taps, NCHW (counterpart of ``relaxtpu/models/vgg.py:19-66``).

The reference's VGG ablations tap the raw outputs of the 13 convs of
torchvision's ``vgg16.features`` and ``classifier[3]`` (``fc2``), as forward
hooks see them: before the ReLU.  Parameter names follow torchvision
(``features.<i>``, ``classifier.0``, ``classifier.3``), so a torchvision
checkpoint restricted to this module's keys (its ``classifier.6``
logits are not tapped) loads as it is.  The convs and linears stay cuDNN /
cuBLAS calls: the JAX package computes them outside any Pallas kernel.

Inputs are 224x224: the adaptive 7x7 average pool is then the identity,
and the JAX model leaves it out.
"""

from __future__ import annotations

import torch
import torch.nn as nn

# conv channel plan of torchvision's vgg16; 'M' = 2x2 max pool
_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M")

# torchvision ``features`` indices of the 13 convs, in order
VGG_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG_TAPS = tuple(f"conv{i}" for i in VGG_CONV_INDICES)
VGG_STACK_DIM = 64 + 64 + 128 + 128 + 256 * 3 + 512 * 6  # 4,224


class VGG16(nn.Module):
    """forward((B, 3, 224, 224) ImageNet-normalised, reduce) returns
    {'conv<i>': tap, 'fc2': (B, 4096) f32}: each tap the conv's output
    before its ReLU, as f32 channel means (B, C) for ``reduce="mean"`` or
    the raw (B, C, H, W) map in the module's dtype for ``reduce=None``;
    ``fc2`` is ``classifier[3]``'s output before its ReLU."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for item in _VGG16_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                # not in place: a raw tap keeps the conv's output
                layers += [nn.Conv2d(cin, item, 3, padding=1), nn.ReLU()]
                cin = item
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(), nn.Linear(4096, 4096)
        )

    def forward(self, x: torch.Tensor, reduce: str | None = "mean") -> dict[str, torch.Tensor]:
        taps = {}
        for i, m in enumerate(self.features):
            x = m(x)
            if isinstance(m, nn.Conv2d):
                taps[f"conv{i}"] = x.float().mean(dim=(2, 3)) if reduce == "mean" else x
        x = self.classifier(x.flatten(1))  # (C, H, W) order, as torch flattens
        taps["fc2"] = x.float()
        return taps
