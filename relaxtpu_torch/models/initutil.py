"""Seeded random weights, for runs without pretrained checkpoints.

Counterpart of ``relaxtpu/models/initutil.py``: the same FLOPs and the same
code path as the real weights, from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn as nn


@torch.no_grad()
def random_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and BN statistic of ``module`` from ``seed``:
    convs He-normal, linears normal(1/fan_in), biases zero, norms identity,
    BN running stats randomised, ViT tokens normal(0.02)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            normal(m.weight, (2.0 / fan_in) ** 0.5 if isinstance(m, nn.Conv2d) else fan_in**-0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            normal(m.running_mean, 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for name in ("cls_token", "pos_embed"):
        if hasattr(module, name):
            normal(getattr(module, name), 0.02)
    return module
