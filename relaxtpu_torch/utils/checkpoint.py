"""relaxtpu's flat ``.npz`` model snapshots, read and written.

Counterpart of ``relaxtpu/utils/checkpoint.py:16-55``: keys ``params/a/b``
and ``stats/a/b`` hold the Flax ``params`` and ``batch_stats`` trees
(``params/fc1/kernel`` is ``fc1.weight`` transposed, ``stats/bn1/mean`` is
``bn1.running_mean``), so a head trained by the port loads into the JAX
package and the other way round.
"""

from __future__ import annotations

import os

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


def save_snapshot(path: str, snapshot) -> None:
    """A ``model.train.ModelSnapshot`` -> ``.npz`` in relaxtpu's layout."""
    state = {k: v.detach().cpu().numpy() for k, v in snapshot.state.items()}
    flat = {}
    for name in ("fc1", "fc2", "fc3"):
        flat[f"params/{name}/kernel"] = state[f"{name}.weight"].T
        flat[f"params/{name}/bias"] = state[f"{name}.bias"]
    if "bn1.weight" in state:
        flat["params/bn1/scale"] = state["bn1.weight"]
        flat["params/bn1/bias"] = state["bn1.bias"]
        flat["stats/bn1/mean"] = state["bn1.running_mean"]
        flat["stats/bn1/var"] = state["bn1.running_var"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_snapshot(path: str):
    """``.npz`` snapshot -> ``model.train.ModelSnapshot`` on the CPU."""
    from relaxtpu_torch.model.train import ModelSnapshot
    from relaxtpu_torch.models.porters import mlp_from_jax

    return ModelSnapshot(mlp_from_jax(load_snapshot_variables(path)))
