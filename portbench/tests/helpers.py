"""A tiny cell for CPU rehearsals: ViT depth 2, 64x64 frames, 4 frames and
4 pairs a clip, two clips in the pool."""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, spec  # noqa: E402


def tiny_cell(name: str = "f32-konvid540-stream", **traffic) -> spec.Cell:
    cell = spec.resolve(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["vit"]["depth"] = 2
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic.update(dict(width=64, height=64, framerate=4, clip_seconds=2, pool=2, warmup_videos=1,
                             trace_videos=2, trace_after=0.0), **traffic)
    return cell


def tiny_run(cell: spec.Cell, seed: int = 3_000_000_021, seconds: float = 1.0, trace: int = 0) -> dict:
    import torch

    torch.set_num_threads(2)
    args = harness.parse(["--workload", cell.name, "--seed", str(seed), "--seconds", str(seconds),
                          "--trace", str(trace)])
    import time

    return harness.run(args, time.perf_counter(), device="cpu", cell=cell)
