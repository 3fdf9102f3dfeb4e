"""The ('data', 'model') mesh on ``torch.distributed`` (counterpart of
``relaxtpu/parallel/mesh.py``).

JAX drives a grid of devices from one process.  PyTorch runs one process
per device (``torchrun``), so here the mesh's cells are the ranks of the
process group: rank r sits at ``(data, model) = divmod(r, n_model)``, the
row-major order of JAX's ``devices[:needed].reshape(n_data, n_model)``.
Ranks that share a model index form the data group (batch shards, gradient
sums, the gather of results); ranks that share a data index form the model
group (the split of fc1's input rows).

JAX's ``data_sharding`` and ``replicate`` name where an array lives on its
mesh; they have no torch object.  Here a rank holds its own shard of the
batch (``shard_batch``, ``distributed.shard_videos``) or a whole copy (the
replicated backbones and head layers), and the collectives in
``parallel.distributed`` say what crosses ranks.

No hidden CPU: JAX's ``make_mesh`` falls back to virtual CPU devices when
the default backend has too few; this one raises when the world does not
fill the mesh exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from relaxtpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a ('data', 'model') mesh of ranks.

    ``data_group`` and ``model_group`` are process groups (None in a world
    of one process, where no collective runs); ``device`` is where this
    rank computes."""

    shape: dict
    rank: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object
    device: torch.device


def world() -> tuple[int, int]:
    """(rank, world size): (0, 1) without an initialised process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None) -> Mesh:
    """The mesh over every rank of the process group (a world of one
    without one).  ``n_data`` None takes the world over ``n_model``.
    ``n_data * n_model`` must equal the world size.  Every rank must call
    this, in the same order as the other ranks' other group creations:
    each rank creates every group."""
    rank, size = world()
    if n_model < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"mesh axes must be positive, got data={n_data}, model={n_model}")
    if n_data is None:
        if size < n_model:
            raise ValueError(f"mesh needs {n_model} ranks on the model axis; the world has {size}")
        n_data = size // n_model
    needed = n_data * n_model
    if needed != size:
        raise ValueError(f"mesh needs {needed} ranks (data={n_data} x model={n_model}); "
                         f"the world has {size}")
    data_index, model_index = divmod(rank, n_model)
    data_group = model_group = None
    if dist.is_initialized():
        for m in range(n_model):  # the ranks that share model index m
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            data_group = g if m == model_index else data_group
        for d in range(n_data):  # the ranks that share data index d
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            model_group = g if d == data_index else model_group
    return Mesh({"data": n_data, "model": n_model}, rank, data_index, model_index,
                data_group, model_group, resolve_device(device))


def shard_batch(mesh: Mesh, *arrays):
    """Pad the leading dim to a multiple of the data axis with copies of the
    last row, and take this rank's contiguous shard of each array.

    Returns (shard, ..., real_count); callers gather the shards' results
    and slice the rows past ``real_count`` off.  numpy arrays and tensors
    both work."""
    n, i = mesh.shape["data"], mesh.data_index
    out, real = [], None
    for a in arrays:
        real = len(a) if real is None else real
        pad = (-len(a)) % n
        if pad:
            if isinstance(a, torch.Tensor):
                a = torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
            else:
                a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
        k = len(a) // n
        out.append(a[i * k : (i + 1) * k])
    return (*out, real)
