"""Process groups and the collectives of the sharded paths (counterpart of
``relaxtpu/parallel/distributed.py``).

One process per device, started with ``torchrun`` (or any launcher that
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``).  Videos are dealt round-robin to the ranks, which never
talk during extraction; the (n_videos, 35,203) matrix is all-gathered once
at the end.

NCCL places one rank on one device and refuses two ranks on one device.
gloo runs anywhere: on the CPU, and for several ranks sharing one card
(CUDA tensors then cross through the host, which gloo's collectives need).

Every process group gets a timeout, so a rank that fails or never arrives
ends the run with an error instead of a wait without end.
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from relaxtpu_torch.device import resolve_device
from relaxtpu_torch.parallel.mesh import Mesh, make_mesh, world

log = logging.getLogger("relaxtpu_torch.parallel.distributed")

TIMEOUT = datetime.timedelta(minutes=30)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE")


def launched() -> bool:
    """Whether a launcher (torchrun) set this process's rank and world."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def initialize(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
               backend: str | None = None, device=None,
               timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join the process group (idempotent) -> this rank's device.

    The arguments fall back to torchrun's environment (``RANK``,
    ``WORLD_SIZE``; ``env://`` reads ``MASTER_ADDR`` and ``MASTER_PORT``).
    ``device`` (default CUDA) picks the backend unless ``backend`` names
    one: NCCL for CUDA, gloo for the CPU.  On CUDA a device without an index
    becomes ``cuda:LOCAL_RANK`` and is made current; ``cuda:N`` stays N, so
    gloo ranks may share one card.  ``timeout`` bounds the wait of every
    collective of the group, so a rank that never arrives fails the run.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        log.info("process group already initialised (rank %d of %d)", *world())
        return dev
    if rank is None or world_size is None:
        if not launched():
            raise RuntimeError("no process group: start the ranks with torchrun (which sets RANK and "
                               "WORLD_SIZE), or pass init_method, world_size and rank")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size,
                            rank=rank, timeout=timeout)
    log.info("rank %d of %d joined (%s, %s)", rank, world_size, backend, dev)
    return dev


def shard_videos(items, index: int | None = None, count: int | None = None) -> list:
    """This rank's videos: round-robin ``items[index::count]`` (index and
    count default to the rank and the world size).  Round-robin, not
    contiguous blocks, balances long and short videos that cluster in
    dataset order."""
    rank, size = world()
    return list(items)[(rank if index is None else index) :: (size if count is None else count)]


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses through the host: gloo takes CUDA tensors in
    few of its collectives."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (nothing to do without a group)."""
    if group is None:
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in the
    group's rank order, on ``t``'s device."""
    if group is None:
        return t
    src = t.cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def _collective_device(group) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(group) == "nccl" \
        else torch.device("cpu")


def allgather_video_features(local_indices, local_vecs, n_videos: int, group=None) -> np.ndarray:
    """(n_videos, D) numpy matrix assembled from every rank's rows,
    identical on every rank of ``group`` (the world by default).

    ``local_indices`` (n_local,) are the input positions of this rank's
    rows ``local_vecs`` (n_local, D), a numpy array or a tensor on any
    device; a rank with no videos passes (0, D).  Each rank pads to the
    largest local count (index -1, zero rows) so the gathers have one
    shape.  Without a process group it is the identity scatter."""
    idx = torch.as_tensor(np.asarray(local_indices, np.int64)).reshape(-1)
    vecs = local_vecs if isinstance(local_vecs, torch.Tensor) else torch.from_numpy(np.asarray(local_vecs))
    if vecs.dim() != 2 or len(vecs) != len(idx):
        raise ValueError(f"local_vecs must be (n_local, D) for {len(idx)} indices, got {tuple(vecs.shape)}")
    if dist.is_initialized():
        group = group or dist.group.WORLD
        dev = _collective_device(group)
        counts = all_gather_rows(torch.tensor([len(idx)], device=dev), group)
        pad = int(counts.max()) - len(idx)
        idx = all_gather_rows(torch.cat([idx, idx.new_full((pad,), -1)]).to(dev), group)
        vecs = all_gather_rows(torch.cat([vecs, vecs.new_zeros((pad, vecs.shape[1]))]).to(dev), group)
    idx, vecs = idx.cpu(), vecs.cpu()
    valid = idx >= 0
    out = torch.zeros((n_videos, vecs.shape[1]), dtype=vecs.dtype)
    out[idx[valid]] = vecs[valid]
    return out.numpy()


def global_data_mesh(n_model: int = 1, device=None) -> Mesh:
    """``make_mesh`` over the whole world: the data axis takes what the
    model axis leaves."""
    return make_mesh(None, n_model, device)
