"""Per-frame pooling statistics over backbone taps (counterpart of
``relaxtpu/features/aggregate.py``)."""

from __future__ import annotations

import torch

from relaxtpu_torch.models.resnet import RESNET_TAPS


def layer_stack_feature(taps: dict[str, torch.Tensor]) -> torch.Tensor:
    """Concat the 15 tap channel means in spec order -> (B, 13120)."""
    return torch.cat([taps[name] for name in RESNET_TAPS], dim=-1)


def resnet_pool_feature(avgpool: torch.Tensor) -> torch.Tensor:
    """(B, 2048) avgpool -> (B, 2051) = [vector | mean | max | std (ddof 0)]."""
    return torch.cat(
        [
            avgpool,
            avgpool.mean(dim=-1, keepdim=True),
            avgpool.amax(dim=-1, keepdim=True),
            avgpool.std(dim=-1, keepdim=True, correction=0),
        ],
        dim=-1,
    )
