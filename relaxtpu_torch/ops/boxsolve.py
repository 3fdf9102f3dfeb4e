"""Fused box blur and 2x2 flow solve (kernel K2).

Counterpart of the Pallas kernel ``relaxtpu/ops/boxsolve.py::_box_solve_kernel``,
which computes ``relaxtpu/ops/flow.py::_update_flow`` (``flow.py:318-337``):
a winsize x winsize replicate-border box sum of the five normal-equation
planes, times 1/winsize^2, then the per-pixel 2x2 solve.  K2
(``csrc/boxsolve.cu``) keeps the box sums in shared memory and registers
and writes only the two flow planes.

``box_blur_solve`` launches K2 for CUDA tensors and runs the plain PyTorch
version for CPU tensors: M (P, 5, H, W) f32 -> flow (P, 2, H, W) f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from relaxtpu_torch import _native


def box_sum_plain(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """winsize x winsize box sum with replicate border of (P, C, H, W):
    direct sums, vertical then horizontal, in K2's order."""
    r = winsize // 2
    h, w = m.shape[-2:]
    x = F.pad(m, (r, r, r, r), mode="replicate")
    v = x[..., 0:h, :]
    for d in range(1, winsize):
        v = v + x[..., d : d + h, :]
    s = v[..., 0:w]
    for d in range(1, winsize):
        s = s + v[..., d : d + w]
    return s


def box_blur_solve_plain(m: torch.Tensor, winsize: int = 15) -> torch.Tensor:
    """Plain PyTorch K2: ``_box_blur`` + ``_update_flow``."""
    mb = box_sum_plain(m, winsize) * (1.0 / (winsize * winsize))
    g11, g12, g22, h1, h2 = mb.unbind(dim=1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet], dim=1)


def box_blur_solve(m: torch.Tensor, winsize: int = 15) -> torch.Tensor:
    """Box-averaged 2x2 solve -> new flow (P, 2, H, W).

    CUDA tensors launch K2; CPU tensors take the plain version.
    """
    if winsize % 2 != 1:
        raise ValueError("box window must be odd")
    if m.device.type == "cpu":
        return box_blur_solve_plain(m, winsize)
    _native.check_cuda_input(m, "m", torch.float32, 4)
    p, c, h, w = m.shape
    if c != 5:
        raise ValueError(f"M must be the 5 normal-equation planes, got shape {tuple(m.shape)}")
    flow = torch.empty((p, 2, h, w), dtype=torch.float32, device=m.device)
    _native.launch("relax_box_blur_solve", m.data_ptr(), flow.data_ptr(), p, h, w, winsize)
    box_blur_solve.launches += 1
    return flow


box_blur_solve.launches = 0
