"""Farneback matrix update with an exact bilinear warp (kernel K1).

Counterpart of the Pallas kernel ``relaxtpu/ops/warp.py::_warp_kernel``
together with the rest of ``relaxtpu/ops/flow.py::_update_matrices``
(``flow.py:179-268``).  The TPU kernel is a banded one-hot matmul because
Mosaic cannot gather; Hopper can, so K1 (``csrc/warp.cu``) gathers the four
bilinear corners directly, is exact for any flow, and fuses the whole
matrix update into one launch.  It equals the TPU kernel's result for
motion inside that kernel's band.

``update_matrices`` launches K1 for CUDA tensors and runs the plain PyTorch
version for CPU tensors.  Layouts are planar, batched over pairs:
r0, r1 (P, 5, H, W), flow (P, 2, H, W), M (P, 5, H, W), all f32.
"""

from __future__ import annotations

import numpy as np
import torch

from relaxtpu_torch import _native

_BORDER_W = (0.14, 0.14, 0.4472, 0.4472, 0.4472)  # edge confidence taper


def border_scale(h: int, w: int) -> np.ndarray:
    """(H, W) f32 confidence taper: product of per-side 5-pixel ramps."""
    ramp = np.asarray(_BORDER_W, np.float32)
    k = len(ramp)

    def side(nn: int) -> np.ndarray:
        s = np.ones(nn, np.float32)
        m = min(k, nn)
        s[:m] *= ramp[:m]
        s[nn - m :] *= ramp[:m][::-1]
        return s

    return side(h)[:, None] * side(w)[None, :]


def _corners(flow: torch.Tensor):
    """Unclipped floor, fractions and clipped corner indices of x + flow."""
    _, _, h, w = flow.shape
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    fx = xs + flow[:, 0]
    fy = ys + flow[:, 1]
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    xi = x1.clamp(0, w - 2).to(torch.int64)
    yi = y1.clamp(0, h - 2).to(torch.int64)
    return x1, y1, fx - x1, fy - y1, xi, yi


def warp_planes_plain(planes: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (P, C, H, W) planes at (x + dx, y + dy); corner
    indices clipped to [0, W-2] x [0, H-2], fractions from the unclipped
    floor (``flow.py:179-209``).  Not ``F.grid_sample``: its border rule
    differs."""
    p, c, h, w = planes.shape
    _, _, tx, ty, xi, yi = _corners(flow)
    flat = planes.reshape(p, c, h * w)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(p, 1, h * w).expand(p, c, h * w)
        return torch.gather(flat, 2, idx).reshape(p, c, h, w)

    tx = tx[:, None]
    ty = ty[:, None]
    return (
        (1 - tx) * (1 - ty) * at(yi, xi)
        + tx * (1 - ty) * at(yi, xi + 1)
        + (1 - tx) * ty * at(yi + 1, xi)
        + tx * ty * at(yi + 1, xi + 1)
    )


def update_matrices_plain(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: ``_update_matrices(r0, r1, flow, warp="exact")``."""
    _, _, h, w = flow.shape
    x1, y1, _, _, _, _ = _corners(flow)
    inside = (x1 >= 0) & (x1 <= w - 2) & (y1 >= 0) & (y1 <= h - 2)
    r1w = warp_planes_plain(r1, flow)
    dx = flow[:, 0]
    dy = flow[:, 1]

    r2 = torch.where(inside, (r0[:, 0] - r1w[:, 0]) * 0.5, r0[:, 0] * 0.5)
    r3 = torch.where(inside, (r0[:, 1] - r1w[:, 1]) * 0.5, r0[:, 1] * 0.5)
    r4 = torch.where(inside, (r0[:, 2] + r1w[:, 2]) * 0.5, r0[:, 2])
    r5 = torch.where(inside, (r0[:, 3] + r1w[:, 3]) * 0.5, r0[:, 3])
    r6 = torch.where(inside, (r0[:, 4] + r1w[:, 4]) * 0.25, r0[:, 4] * 0.5)

    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    scale = torch.from_numpy(border_scale(h, w)).to(flow.device)
    r2, r3, r4, r5, r6 = (t * scale for t in (r2, r3, r4, r5, r6))
    return torch.stack(
        [
            r4 * r4 + r6 * r6,
            (r4 + r5) * r6,
            r5 * r5 + r6 * r6,
            r4 * r2 + r6 * r3,
            r6 * r2 + r5 * r3,
        ],
        dim=1,
    )


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Normal-equation planes M = [G11, G12, G22, h1, h2] -> (P, 5, H, W).

    CUDA tensors launch K1; CPU tensors take the plain version.
    """
    if flow.device.type == "cpu":
        return update_matrices_plain(r0, r1, flow)
    p, two, h, w = flow.shape
    if two != 2 or h < 2 or w < 2:
        raise ValueError(f"flow must be (P, 2, H, W) with H, W >= 2, got {tuple(flow.shape)}")
    for name, t, c in (("r0", r0, 5), ("r1", r1, 5), ("flow", flow, 2)):
        _native.check_cuda_input(t, name, torch.float32, 4)
        if tuple(t.shape) != (p, c, h, w):
            raise ValueError(f"{name} must be {(p, c, h, w)}, got {tuple(t.shape)}")
    m = torch.empty((p, 5, h, w), dtype=torch.float32, device=flow.device)
    _native.launch(
        "relax_update_matrices", r0.data_ptr(), r1.data_ptr(), flow.data_ptr(),
        m.data_ptr(), p, h, w,
    )
    update_matrices.launches += 1
    return m


update_matrices.launches = 0
