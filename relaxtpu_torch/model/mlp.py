"""The MOS-regression MLP head, eval mode (counterpart of
``relaxtpu/model/mlp.py:24-100``).

Linear(D->256) -> BatchNorm1d (running stats, eps 1e-5) -> exact GELU ->
Dropout -> Linear(256->128) -> GELU -> Dropout -> Linear(128->1), with the
reference's parameter names, so its ``.pth`` checkpoints load as they are
after ``fix_state_dict``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch.nn as nn
import torch.nn.functional as F

from relaxtpu_torch.features.layout import TOTAL_FEATURE_DIM


class Mlp(nn.Module):
    def __init__(self, in_features: int = TOTAL_FEATURE_DIM, hidden_features: int = 256,
                 out_features: int = 1, drop_rate: float = 0.2, use_bn: bool = True):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.bn1 = nn.BatchNorm1d(hidden_features, eps=1e-5) if use_bn else nn.Identity()
        self.drop = nn.Dropout(drop_rate)
        self.fc2 = nn.Linear(hidden_features, hidden_features // 2)
        self.fc3 = nn.Linear(hidden_features // 2, out_features)

    def forward(self, x):
        x = self.drop(F.gelu(self.bn1(self.fc1(x))))
        x = self.drop(F.gelu(self.fc2(x)))
        return self.fc3(x)


def fix_state_dict(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Strip the SWA AveragedModel wrapper (``module.`` prefix, ``n_averaged``)."""
    out = {}
    for k, v in sd.items():
        if k == "n_averaged":
            continue
        out[k[7:] if k.startswith("module.") else k] = v
    return out
