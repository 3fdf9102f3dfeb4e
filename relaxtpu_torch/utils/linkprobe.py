"""Host-to-device link probe and the serving-mode choice (counterpart of
``relaxtpu/utils/linkprobe.py``).

``predict-batch --batch auto`` streams videos one program at a time or
batches them, from the measured upload rate and round trip: batching saves
per-program round trips and costs some of the overlap of uploads with
compute.  On the H100 the link is PCIe from the host's pinned memory.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from relaxtpu_torch.device import resolve_device


def measure_link(n_mb: int = 64, reps: int = 3, device=None) -> dict:
    """Upload rate and round trip between the host and ``device``.

    Rate: a pinned upload of ``n_mb`` MiB of random bytes (random, so no
    link compresses them), a device sum and a fetch of the scalar, best and
    worst of ``reps`` after a warm-up.  Round trip: the same on 1 KiB,
    averaged over 5.  -> ``{"link_MBps", "link_MBps_worst", "rtt_ms"}``.
    """
    dev = resolve_device(device)
    buf = torch.from_numpy(np.random.default_rng(2).integers(0, 255, n_mb << 20, dtype=np.uint8))
    if dev.type == "cuda":
        buf = buf.pin_memory()
    small = buf[:1024].clone().pin_memory() if dev.type == "cuda" else buf[:1024].clone()

    def once(t: torch.Tensor) -> int:
        return int(t.to(dev, non_blocking=True).sum(dtype=torch.int32))

    once(small)
    once(buf)
    best, worst = float("inf"), 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        once(buf)
        dt = time.perf_counter() - t0
        best, worst = min(best, dt), max(worst, dt)
    t0 = time.perf_counter()
    for _ in range(5):
        once(small)
    rtt_ms = (time.perf_counter() - t0) / 5 * 1000
    return {"link_MBps": round(n_mb / best, 1), "link_MBps_worst": round(n_mb / worst, 1),
            "rtt_ms": round(rtt_ms, 2)}


def pick_serving_mode(bytes_per_video: int, link: dict, batch: int = 4) -> tuple[int, str]:
    """(videos a program, reason) from a link probe, as the JAX package
    picks: streaming spends ~1.5 extra round trips a video that a batch of
    ``batch`` saves, and batching loses ~10% of the upload's overlap with
    compute; batch wins when the first exceeds the second."""
    transfer_s = bytes_per_video / (link["link_MBps"] * 1e6)
    rtt_saving_s = 1.5 * link["rtt_ms"] / 1000.0
    overlap_loss_s = 0.10 * transfer_s
    if rtt_saving_s > overlap_loss_s:
        return batch, (
            f"dispatch-bound: 1.5x rtt ({rtt_saving_s * 1e3:.1f} ms) > 10% of "
            f"per-video transfer ({transfer_s * 1e3:.0f} ms) -> batch {batch}"
        )
    return 1, (
        f"transfer-bound: per-video transfer {transfer_s * 1e3:.0f} ms dwarfs "
        f"rtt {link['rtt_ms']:.1f} ms -> streaming"
    )
