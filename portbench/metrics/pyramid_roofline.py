"""pyramid_roofline: the flow's pyramid level kernel's share (%) of its
roofline: the least time of its calls over the device time of their kernel
records.  Only calls whose record the profiler kept count, each with its
own work.  A program without ``pyramid_level`` (before the kernel) gets no
range and reads nothing."""

import functools
import importlib

import numpy as np

from portbench import counts
from portbench.reference.ops import weight_matrix

if hasattr(importlib.import_module("relaxtpu_torch.ops.flow"), "pyramid_level"):
    CALLS = ("relaxtpu_torch.ops.flow", "pyramid_level")  # the level as the flow calls it
KERNEL = "pyramid_level_kernel"


def _sampled(n_in: int, n_out: int) -> np.ndarray:
    """The input indices a resize from n_in to n_out reads (a non-zero
    weight, linear without antialias); all of them where the size stays."""
    if n_in == n_out:
        return np.arange(n_in)
    return np.flatnonzero(weight_matrix(n_in, n_out, "linear", False).any(axis=0))


@functools.lru_cache(maxsize=64)
def _sums(h: int, w: int, hk: int, wk: int, ksize: int) -> int:
    """The smoothing's sums an image needs: horizontal at every input row
    that a sampled row's taps reach and every sampled column, vertical at
    the sampled rows and columns."""
    rows, cols = _sampled(h, hk), _sampled(w, wk)
    r = ksize // 2
    reach = np.zeros(h, bool)
    for y in rows:
        reach[max(0, y - r) : y + r + 1] = True
    return (int(reach.sum()) + len(rows)) * len(cols)


def bound_s(prev_gray, next_gray, ksize, sigma, hk, wk):
    """2 P grey images of H x W: each read once (1 byte a pixel for uint8,
    4 for f32) and the level written (4 bytes an output pixel) at the memory
    rate, or the smoothing's rounded products and adds at the points the
    resize reads (k taps: k products and k - 1 adds a sum), horizontal at
    every input row that a sampled row's taps reach and every sampled
    column, vertical at the sampled rows and columns, at the add rate (the
    resize's own few operations are left out: a lower bound)."""
    p, h, w = prev_gray.shape
    nbytes = 2 * p * (h * w * prev_gray.element_size() + hk * wk * 4)
    ops = 2 * p * _sums(h, w, hk, wk, ksize) * (2 * ksize - 1)
    return counts.bound_s(nbytes, ops, counts.F32_ADDS_PER_S)


def read(ctx):
    return ctx.roofline("pyramid_roofline", KERNEL)
