"""The serving programs' spans' own cost on the card.

Two measurements, each with the profiler off and on (CPU and CUDA):

- one span: ``with span("x"): pass`` against ``with`` a do-nothing
  context, many times over (us a span);
- one 540p ``video_feature_async_i420`` call (16 frames + 16 pairs, bf16,
  seeded random weights), host ms, waited for after each call, with the
  spans as they are and with ``pipeline.span`` replaced by a do-nothing
  context (the program before the spans), the two in alternate calls, so
  that each pair of neighbouring calls gives one difference.

    python scripts/torch_span_cost.py [--rounds 10] [--videos 10] [--out chiprun_out/span_cost.json]
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import relaxtpu_torch.features.pipeline as pipeline  # noqa: E402
from relaxtpu_torch.features.pipeline import FeatureExtractor  # noqa: E402
from relaxtpu_torch.models.initutil import random_init_  # noqa: E402
from relaxtpu_torch.models.resnet import ResNet50  # noqa: E402
from relaxtpu_torch.models.vit import ViT  # noqa: E402

H, W, N = 540, 960, 16
NO_SPAN = contextlib.nullcontext()
ACTS = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def profiler(on: bool):
    return torch.profiler.profile(activities=ACTS) if on else contextlib.nullcontext()


def per_span_us(on: bool, n: int) -> dict:
    """us a ``with span(...)`` block, and a ``with`` of a do-nothing context."""
    span = pipeline.span
    out = {}
    with profiler(on):
        for name, ctx in (("span", lambda: span("x")), ("none", lambda: NO_SPAN)):
            t = time.perf_counter()
            for _ in range(n):
                with ctx():
                    pass
            out[name] = (time.perf_counter() - t) / n * 1e6
    return out


def summary(v: list) -> dict:
    return {"median": statistics.median(v), "quartiles": statistics.quantiles(v, n=4)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--videos", type=int, default=10, help="calls a round (even)")
    p.add_argument("--out", default="chiprun_out/span_cost.json")
    args = p.parse_args()

    fx = FeatureExtractor(random_init_(ResNet50(), 0).state_dict(), random_init_(ViT(), 1).state_dict(),
                          dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (N, H * W * 3 // 2), dtype=np.uint8)
    nexts = rng.integers(0, 256, (N, H * W * 3 // 2), dtype=np.uint8)
    spans = pipeline.span

    def enqueue_ms(with_spans: bool) -> float:
        pipeline.span = spans if with_spans else (lambda name: NO_SPAN)
        try:
            t = time.perf_counter()
            vec = fx.video_feature_async_i420(frames, nexts, H, W)
            ms = (time.perf_counter() - t) * 1e3
            vec.cpu()
            return ms
        finally:
            pipeline.span = spans

    for on in (False, True):  # warm-up: kernels, caches, the profiler's first start
        with profiler(on):
            enqueue_ms(True)
            enqueue_ms(False)
    out = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__, "calls_per_mode": 0}
    for on in (False, True):
        key = "on" if on else "off"
        times = {"spans": [], "none": []}
        diffs = []
        ranges = 0
        for r in range(args.rounds):
            with profiler(on) as prof:
                for v in range(0, args.videos, 2):
                    first = (v // 2 + r) % 2 == 0  # which goes first alternates
                    a = enqueue_ms(first)
                    b = enqueue_ms(not first)
                    s, n = (a, b) if first else (b, a)
                    times["spans"].append(s)
                    times["none"].append(n)
                    diffs.append(s - n)
            if on:
                ranges = sum(e.name.startswith("relaxtpu.") and e.device_type == torch.autograd.DeviceType.CPU
                             for e in prof.events()) / (args.videos // 2)
        out["calls_per_mode"] = len(diffs)
        out[f"enqueue_host_ms_{key}"] = {k: summary(v) for k, v in times.items()}
        out[f"spans_minus_none_ms_{key}"] = summary(diffs)
        out[f"span_us_{key}"] = per_span_us(on, 200_000 if not on else 20_000)
        if on:
            out["ranges_per_video"] = ranges
    print(json.dumps(out, indent=1))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
