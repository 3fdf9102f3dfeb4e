"""``jax.image.resize`` as two matrix products.

The JAX package resizes with ``jax.image.resize``: "linear" without
antialias for the flow pyramid and the flow upsample
(``relaxtpu/ops/flow.py:96-101,399-401``), and "linear" / "lanczos3" with
antialias to 224x224 for the backbones (``relaxtpu/features/pipeline.py:84-86``),
and "bicubic" with antialias for the ViT's position table at inputs other
than 224x224 (``relaxtpu/models/vit.py:103-117``).  Torch has no lanczos3,
its bicubic is Keys' cubic with a = -0.75, not jax's a = -0.5, and it
antialiases differently, so this module builds
jax's own separable weight matrices in numpy (its scale-and-translate rule:
half-pixel centres, the kernel widened by 1/scale when downsampling with
antialias, columns renormalised, samples outside the input zeroed) and
applies them as ``Wh @ x @ Ww^T``.

Each matrix is copied to a device once, through pinned memory without
blocking, and kept there (``device_matrix``): a resize on the device path
makes no host-to-device copy after its first use, so it never waits for
the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from relaxtpu_torch.device import upload


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0, 1 - np.abs(x))


def _lanczos3(x: np.ndarray) -> np.ndarray:
    radius = np.float32(3.0)
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi**2 * x**2, 1), 1)
    return np.where(x > radius, 0.0, out)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5, as jax evaluates it."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                   + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out)


_KERNELS = {"linear": _triangle, "lanczos3": _lanczos3, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, method: str, antialias: bool) -> np.ndarray:
    """(out_size, in_size) float32 resampling matrix, jax's
    ``compute_weight_mat`` transposed, computed in float32 as jax does."""
    f32 = np.float32
    scale = f32(out_size / in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _KERNELS[method](x.astype(f32)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1),
        0,
    ).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0).astype(f32).T)


@functools.lru_cache(maxsize=256)
def device_matrix(in_size: int, out_size: int, method: str, antialias: bool,
                  device: torch.device) -> torch.Tensor:
    """``weight_matrix`` on ``device``, built and copied once, without
    blocking."""
    return upload(torch.from_numpy(weight_matrix(in_size, out_size, method, antialias)), device)


def resize_hw(
    x: torch.Tensor, out_hw: tuple[int, int], method: str, antialias: bool
) -> torch.Tensor:
    """Resize the last two axes (..., H, W) of an f32 tensor.

    An axis whose size does not change is left alone, as in jax.
    """
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if oh != h:
        x = torch.matmul(device_matrix(h, oh, method, antialias, x.device), x)
    if ow != w:
        x = torch.matmul(x, device_matrix(w, ow, method, antialias, x.device).T)
    return x


def quantize_u8_levels(x: torch.Tensor) -> torch.Tensor:
    """rint(clip(x, 0, 1) * 255) / 255: the 8-bit image the reference's PIL
    resize produces (``relaxtpu/features/pipeline.py:89``)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0
