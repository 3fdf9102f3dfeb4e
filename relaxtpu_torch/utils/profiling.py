"""Per-stage host timing, program spans and profiler traces (counterpart of
``relaxtpu/utils/profiling.py:18-38``).

``stage_timer`` adds a block's wall seconds into a dict; ``trace_to`` runs
a block under ``torch.profiler`` and writes a Chrome trace (open it in
``chrome://tracing`` or Perfetto) into a directory.

``span(name)`` marks a stage of the serving programs
(``features/pipeline.py``) as a profiler range ``relaxtpu.<name>``,
recorded only while a ``torch.profiler`` records in this process (a flag
read otherwise).  The ranges are the profiler's own events, on the clock of
its device records, so a ``trace_to`` trace (``extract --profile-dir``)
carries them beside the kernels they launched:

- ``relaxtpu.enqueue``: one call of a public program, the root that every
  other span of the call nests in;
- ``relaxtpu.upload``: host staging into pinned memory and the copy to the
  device;
- ``relaxtpu.colorspace``: I420 -> BGR on the device;
- ``relaxtpu.fragments``: residuals, patch ranking, gathers, grey, the flow
  image and the merge, holding ``relaxtpu.flow`` (the Farneback flow);
- ``relaxtpu.prep``: the backbones' resize, quantisation, normalisation
  and cast;
- ``relaxtpu.resnet``, ``relaxtpu.vit``: each network's forward;
- ``relaxtpu.aggregate``: the taps' statistics, the fragment rows and the
  means.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch
from torch.autograd import profiler as _profiler

log = logging.getLogger("relaxtpu_torch.profiling")

_OFF = contextlib.nullcontext()


def span(name: str):
    """``relaxtpu.<name>`` as a profiler range while a profiler records,
    else a shared do-nothing context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function("relaxtpu." + name)
    return _OFF


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
    """Profile the block: host activity with the program's spans, and the
    card's when ``device`` is CUDA.  On the way out the trace goes to
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
