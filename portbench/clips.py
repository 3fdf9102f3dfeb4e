"""The traffic generator: a pool of seeded clips held on the host as packed
I420, as a decoder hands them over.

A traffic file gives the geometry (width, height, frame rate, clip seconds), the
pool's size, the loop (clients and videos in flight), and the content: a
blurred random texture panned smoothly (a few px a frame) plus per-frame
noise.  Which frames of a clip are made, and how they are grouped, is the
model family's sampler's (``families/<name>.py``: ``sample``).  Every seed
gives the same sizes and counts; only the content differs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .weights import sub_seed


def n_frames(traffic: dict) -> int:
    """The raw frames of one clip."""
    return int(round(traffic["framerate"] * traffic["clip_seconds"]))


@dataclasses.dataclass
class Clip:
    groups: dict  # the sampler's group name -> (n, H*W*3/2) uint8 packed I420 of its frames
    h: int
    w: int


def bgr_to_i420(bgr: torch.Tensor) -> np.ndarray:
    """(n, h, w, 3) uint8 BGR on any device -> packed I420 (n, h*w*3/2) on
    the host, BT.601 limited range, 2x2 chroma means."""
    b, g, r = bgr.float().unbind(-1)
    y = 0.257 * r + 0.504 * g + 0.098 * b + 16.0
    u = -0.148 * r - 0.291 * g + 0.439 * b + 128.0
    v = 0.439 * r - 0.368 * g - 0.071 * b + 128.0

    def sub(c):
        return (c[:, 0::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 0::2] + c[:, 1::2, 1::2]) * 0.25

    def u8(c):
        return c.round().clamp(0, 255).to(torch.uint8).reshape(len(bgr), -1)

    return torch.cat([u8(y), u8(sub(u)), u8(sub(v))], dim=1).cpu().numpy()


def synthetic_bgr(ts: list[int], traffic: dict, seed: int, device) -> torch.Tensor:
    """(len(ts), h, w, 3) uint8 frames at raw indices ``ts`` of one clip: a
    texture blurred by a Gaussian of ``blur_sigma`` px, panned by integer
    offsets along sines of amplitude ``pan_px`` and period ``pan_period``
    frames (direction and phase from the seed), plus Gaussian noise of
    ``noise`` levels."""
    h, w, amp = traffic["height"], traffic["width"], traffic["pan_px"]
    margin = int(math.ceil(amp)) + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    ax, ay, px, py = (torch.rand(4, generator=gen, device=device) * torch.tensor([0.5, 0.5, 6.283, 6.283], device=device)
                      + torch.tensor([0.5, 0.5, 0.0, 0.0], device=device)).tolist()
    tex = torch.rand((3, 1, h + 2 * margin, w + 2 * margin), generator=gen, device=device) * 255
    r = int(math.ceil(3 * traffic["blur_sigma"]))
    x = torch.arange(-r, r + 1, device=device, dtype=torch.float32)
    g = torch.exp(-x * x / (2 * traffic["blur_sigma"] ** 2))
    g = g / g.sum()
    tex = F.conv2d(F.pad(tex, (r, r, 0, 0), mode="reflect"), g.view(1, 1, 1, -1))
    tex = F.conv2d(F.pad(tex, (0, 0, r, r), mode="reflect"), g.view(1, 1, -1, 1))[:, 0]
    omega = 2 * math.pi / traffic["pan_period"]
    out = torch.empty((len(ts), h, w, 3), dtype=torch.uint8, device=device)
    for i, t in enumerate(ts):
        ox = margin + int(round(amp * ax * math.sin(omega * t + px)))
        oy = margin + int(round(amp * ay * math.sin(omega * t + py)))
        fr = tex[:, oy:oy + h, ox:ox + w] + torch.randn((3, h, w), generator=gen, device=device) * traffic["noise"]
        out[i] = fr.clamp(0, 255).to(torch.uint8).permute(1, 2, 0)
    return out


def pool(traffic: dict, groups: dict, seed: int, device) -> list[Clip]:
    """``traffic["pool"]`` clips from ``seed``, made on ``device`` and held on
    the host: of each, the frames at the raw indices of ``groups`` ({name:
    [index]}, the family's ``sample(traffic)``), grouped so."""
    ts = sorted(set().union(*groups.values()))
    pos = {t: i for i, t in enumerate(ts)}
    out = []
    for c in range(traffic["pool"]):
        i420 = bgr_to_i420(synthetic_bgr(ts, traffic, sub_seed(seed, "clips", c), device))
        out.append(Clip({g: i420[[pos[t] for t in idx]] for g, idx in groups.items()},
                        traffic["height"], traffic["width"]))
    return out
