"""Read relaxtpu's flat ``.npz`` model snapshots with numpy alone.

Counterpart of ``relaxtpu/utils/checkpoint.py:16-55``: keys ``params/a/b``
and ``stats/a/b`` hold the Flax ``params`` and ``batch_stats`` trees.
"""

from __future__ import annotations

import numpy as np


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_torch_state(path: str, keys) -> dict:
    """A ``.pth`` state dict, restricted to ``keys`` (a torchvision
    ResNet-50 checkpoint also holds the ``fc`` classifier, which the taps do
    not use); raises if one of ``keys`` is missing."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} weights, e.g. {missing[:3]}")
    return {k: sd[k] for k in keys}


def load_snapshot_variables(path: str) -> dict:
    """``.npz`` snapshot -> ``{'params': tree, 'batch_stats': tree}``."""
    with np.load(path) as data:
        params = {k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")}
        stats = {k[len("stats/"):]: data[k] for k in data.files if k.startswith("stats/")}
    return {"params": _unflatten(params), "batch_stats": _unflatten(stats)}
