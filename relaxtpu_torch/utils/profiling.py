"""Per-stage host timing and profiler traces (counterpart of
``relaxtpu/utils/profiling.py:18-38``).

``stage_timer`` adds a block's wall seconds into a dict; ``trace_to`` runs
a block under ``torch.profiler`` and writes a Chrome trace (open it in
``chrome://tracing`` or Perfetto) into a directory.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("relaxtpu_torch.profiling")


@contextlib.contextmanager
def stage_timer(name: str, sink: dict | None = None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
        log.debug("stage %s: %.3fs", name, dt)


@contextlib.contextmanager
def trace_to(logdir: str, device: torch.device):
    """Profile the block: host activity, and the card's when ``device`` is
    CUDA.  On the way out the trace goes to
    ``<logdir>/trace_<time>_<pid>.json`` (the directory is created)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
