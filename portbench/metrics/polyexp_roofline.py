"""polyexp_roofline: the flow's polynomial expansion kernel's share (%) of
its roofline: the least time of its calls over the device time of their
kernel records.  Only calls whose record the profiler kept count, each with
its own work.  A program without ``poly_expansion`` (before the kernel)
gets no range and reads nothing."""

import importlib

from portbench import counts

if hasattr(importlib.import_module("relaxtpu_torch.ops.flow"), "poly_expansion"):
    CALLS = ("relaxtpu_torch.ops.flow", "poly_expansion")  # the expansion as the flow calls it
KERNEL = "poly_expansion_kernel"


def bound_s(img, n, sigma):
    """img (..., H, W): 6 f32 a pixel (the image read, five planes written)
    at the memory rate, or the rounded products and adds a pixel (3 vertical
    and 6 horizontal sums of 2n + 1 taps, 6 multiplies and 2 adds to
    combine them: 206 at n = 5) at the add rate."""
    px = img.numel()
    return counts.bound_s(px * 6 * 4, px * (6 * (2 * n + 1) + 12 * (2 * n + 1) + 8), counts.F32_ADDS_PER_S)


def read(ctx):
    return ctx.roofline("polyexp_roofline", KERNEL)
