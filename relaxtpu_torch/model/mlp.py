"""The MOS-regression MLP head (counterpart of ``relaxtpu/model/mlp.py:24-100``).

Linear(D->256) -> BatchNorm1d (running stats, eps 1e-5) -> exact GELU ->
Dropout -> Linear(256->128) -> GELU -> Dropout -> Linear(128->1), with the
reference's parameter names, so its ``.pth`` checkpoints load as they are
after ``fix_state_dict``.

``forward`` is the eval program.  ``forward_train`` is the JAX package's
train mode: BatchNorm by hand with its ``TorchBatchNorm`` formulas
(normalise with the biased batch variance; running variance updated with
``var * n / max(n - 1, 1)``, so a one-row batch runs, where
``nn.BatchNorm1d`` would raise) and flax's Dropout with masks drawn from an
explicit ``torch.Generator``.  ``flax_init_`` draws flax's ``nn.Dense``
init (LeCun normal kernels, zero biases) from such a generator.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from relaxtpu_torch.features.layout import TOTAL_FEATURE_DIM

# flax's variance_scaling: stddev of the unit normal truncated at +-2
_TRUNC_STD = 0.87962566103423978


class Mlp(nn.Module):
    def __init__(self, in_features: int = TOTAL_FEATURE_DIM, hidden_features: int = 256,
                 out_features: int = 1, drop_rate: float = 0.2, use_bn: bool = True):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.bn1 = nn.BatchNorm1d(hidden_features, eps=1e-5) if use_bn else nn.Identity()
        self.drop = nn.Dropout(drop_rate)
        self.fc2 = nn.Linear(hidden_features, hidden_features // 2)
        self.fc3 = nn.Linear(hidden_features // 2, out_features)
        self.drop_rate = drop_rate
        self.use_bn = use_bn

    def forward(self, x):
        x = self.drop(F.gelu(self.bn1(self.fc1(x))))
        x = self.drop(F.gelu(self.fc2(x)))
        return self.fc3(x)

    def forward_train(self, x: torch.Tensor, gen: torch.Generator | None = None) -> torch.Tensor:
        """Train mode; updates bn1's running stats in place."""
        h = self.fc1(x)
        if self.use_bn:
            h = self._batch_norm_train(h)
        h = _dropout(F.gelu(h), self.drop_rate, gen)
        h = _dropout(F.gelu(self.fc2(h)), self.drop_rate, gen)
        return self.fc3(h)

    def _batch_norm_train(self, h: torch.Tensor) -> torch.Tensor:
        bn = self.bn1
        n = h.shape[0]
        mean = h.mean(dim=0)
        var = h.var(dim=0, correction=0)
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1 - m).add_(m * mean)
            bn.running_var.mul_(1 - m).add_(m * (var * (n / max(n - 1, 1))))
        return (h - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias


def _dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None) -> torch.Tensor:
    """flax's Dropout: keep with probability 1 - rate, scale kept by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


@torch.no_grad()
def flax_init_(mlp: Mlp, gen: torch.Generator) -> Mlp:
    """flax's init: kernels LeCun normal (a unit normal truncated at +-2,
    scaled to std sqrt(1 / fan_in)), biases 0, BatchNorm scale 1, bias 0,
    mean 0, var 1.  Equal in distribution to ``Mlp.init`` of the JAX package,
    not bit-equal."""
    for fc in (mlp.fc1, mlp.fc2, mlp.fc3):
        nn.init.trunc_normal_(fc.weight, 0.0, 1.0, -2.0, 2.0, generator=gen)
        fc.weight.mul_(math.sqrt(1.0 / fc.in_features) / _TRUNC_STD)
        fc.bias.zero_()
    if mlp.use_bn:
        mlp.bn1.reset_parameters()
    return mlp


def fix_state_dict(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Strip the SWA AveragedModel wrapper (``module.`` prefix, ``n_averaged``)."""
    out = {}
    for k, v in sd.items():
        if k == "n_averaged":
            continue
        out[k[7:] if k.startswith("module.") else k] = v
    return out
