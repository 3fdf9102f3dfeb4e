"""Colour-space ops matching OpenCV's uint8 math, on tensors.

Counterpart of ``relaxtpu/ops/colorspace.py:18-158``.  uint8 rounding and
truncation follow the JAX package step for step (fixed-point gray,
truncating uint8 stores, round-half-to-even), so the uint8 outputs are
bit-exact against it; ``flow_to_bgr`` may differ by one LSB where an ulp of
atan2/sqrt crosses a floor.
"""

from __future__ import annotations

import math

import torch


def bgr_to_gray(img_u8: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_BGR2GRAY, 15-bit fixed point: (..., 3) uint8 -> (...) uint8."""
    x = img_u8.to(torch.int32)
    y = (x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + (1 << 14)) >> 15
    return y.to(torch.uint8)


def minmax_normalize_255(x: torch.Tensor) -> torch.Tensor:
    """cv2.normalize(..., 0, 255, NORM_MINMAX) over the last two axes (one
    image per leading index); all zeros when max == min."""
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(hi > lo, 255.0 / (hi - lo), torch.zeros_like(hi))
    return (x - lo) * scale


def hsv_to_bgr_u8(h_u8: torch.Tensor, s_u8: torch.Tensor, v_u8: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_HSV2BGR for uint8 (H in 0..180), truncating store."""
    h6 = h_u8.to(torch.float32) * (6.0 / 180.0)
    fl = torch.floor(h6)
    sector = fl.to(torch.int32) % 6
    f = h6 - fl
    s = s_u8.to(torch.float32) / 255.0
    v = v_u8.to(torch.float32)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    conds = [sector == i for i in range(6)]

    def pick(tab):
        out = tab[5]
        for i in range(4, -1, -1):
            out = torch.where(conds[i], tab[i], out)
        return out

    r = pick((v, q, p, p, t, v))
    g = pick((t, v, v, q, p, p))
    b = pick((p, p, t, v, v, q))
    bgr = torch.stack([b, g, r], dim=-1)
    return torch.clamp(torch.floor(bgr), 0, 255).to(torch.uint8)


def flow_to_bgr(flow: torch.Tensor) -> torch.Tensor:
    """Flow visualisation image: (..., H, W, 2) f32 -> (..., H, W, 3) uint8.

    hue = atan2 angle in [0, 2pi) mapped to 0..180, sat = 255, val = min-max
    normalised magnitude (per image), then uint8 HSV -> BGR.
    """
    fx = flow[..., 0]
    fy = flow[..., 1]
    mag = torch.sqrt(fx * fx + fy * fy)
    ang = torch.atan2(fy, fx)
    ang = torch.where(ang < 0, ang + 2.0 * math.pi, ang)
    hue = ang * (180.0 / math.pi / 2.0)
    val = minmax_normalize_255(mag)
    h_u8 = torch.clamp(torch.floor(hue), 0, 255).to(torch.uint8)
    v_u8 = torch.clamp(torch.floor(val), 0, 255).to(torch.uint8)
    s_u8 = torch.full_like(h_u8, 255)
    return hsv_to_bgr_u8(h_u8, s_u8, v_u8)


def yuv420_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """BT.601 limited-range I420 -> BGR uint8, nearest 2x2 chroma.

    y: (..., H, W) uint8; u, v: (..., H/2, W/2) uint8 -> (..., H, W, 3)
    uint8.  Bit-matches the host converter ``io.video._yuv420_to_bgr_limited``.
    """

    def upsample(c):
        c = c.to(torch.float32)
        return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    yl = 1.164383 * (y.to(torch.float32) - 16.0)
    uu = upsample(u) - 128.0
    vv = upsample(v) - 128.0
    b = yl + 2.017232 * uu
    g = yl - 0.812968 * vv - 0.391762 * uu
    r = yl + 1.596027 * vv
    bgr = torch.stack([b, g, r], dim=-1)
    return torch.clamp(torch.round(bgr), 0, 255).to(torch.uint8)


def unpack_i420(buf: torch.Tensor, h: int, w: int) -> tuple:
    """(n, H*W*3/2) packed I420 -> (y, u, v) plane views."""
    yb = h * w
    cb = (h // 2) * (w // 2)
    y = buf[:, :yb].reshape(-1, h, w)
    u = buf[:, yb : yb + cb].reshape(-1, h // 2, w // 2)
    v = buf[:, yb + cb :].reshape(-1, h // 2, w // 2)
    return y, u, v
