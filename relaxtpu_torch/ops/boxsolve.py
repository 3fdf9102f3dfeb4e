"""Fused box blur and 2x2 flow solve (kernel K2).

Counterpart of the Pallas kernel ``relaxtpu/ops/boxsolve.py::_box_solve_kernel``,
which computes ``relaxtpu/ops/flow.py::_update_flow`` (``flow.py:318-337``):
a winsize x winsize replicate-border box sum of the five normal-equation
planes, times 1/winsize^2, then the per-pixel 2x2 solve.  K2
(``csrc/boxsolve.cu``) forms the direct sums in the plain version's tap
order and writes only the two flow planes.  Like the Pallas kernel it takes
any odd winsize: up to ``STRIP_WINSIZE`` the strip kernel (its halo span
holds a radius of at most 8), above it the generic-radius pair of kernels
(a vertical box sum into a scratch buffer, then the horizontal sum fused
with the solve).

``box_blur_solve`` launches K2 for CUDA tensors and runs the plain PyTorch
version for CPU tensors: M (P, 5, H, W) f32 -> flow (P, 2, H, W) f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from relaxtpu_torch import _native

STRIP_WINSIZE = 17  # the strip kernel's halo span holds a radius of at most 8
_STRIP, _GENERIC = "relax_box_blur_solve", "relax_box_blur_solve_generic"


def _entry(winsize: int) -> str:
    """The K2 entry that runs a window: the strip kernel up to
    ``STRIP_WINSIZE``, the generic-radius kernels above it."""
    return _STRIP if winsize <= STRIP_WINSIZE else _GENERIC


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

    CUDA tensors launch K2 (``launches`` counts every call that does,
    ``generic_launches`` those above ``STRIP_WINSIZE``); CPU tensors take
    the plain version.
    """
    if winsize < 1 or winsize % 2 != 1:
        raise ValueError(f"box window must be odd and positive, got {winsize}")
    if m.device.type == "cpu":
        return box_blur_solve_plain(m, winsize)
    _native.check_cuda_input(m, "m", torch.float32, 4)
    p, c, h, w = m.shape
    if c != 5:
        raise ValueError(f"M must be the 5 normal-equation planes, got shape {tuple(m.shape)}")
    flow = m.new_empty((p, 2, h, w))  # new_empty skips torch.empty's argument parsing on this hot path
    if _entry(winsize) == _STRIP:
        _native.launch(_STRIP, m.device, m.data_ptr(), flow.data_ptr(), p, h, w, winsize)
    else:
        scratch = torch.empty_like(m)  # the vertical sums
        _native.launch(_GENERIC, m.device, m.data_ptr(), scratch.data_ptr(), flow.data_ptr(), p, h, w, winsize)
        box_blur_solve.generic_launches += 1
    box_blur_solve.launches += 1
    return flow


box_blur_solve.launches = 0
box_blur_solve.generic_launches = 0
