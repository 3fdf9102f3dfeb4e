"""k4_roofline: K4's share (%) of its roofline: the least time of its calls
over the device time of their kernel records.  Only calls whose record the
profiler kept count, each with its own work.  The calls are instrumented
where the backbone looks K4 up (as ``k3_roofline`` instruments the ViT's
``mha``), which leaves the wrapper's own launch counter in place.  A program
without the backbone (before FAST-VQA) gets no range and reads nothing."""

import importlib.util
import math

from portbench import counts

if importlib.util.find_spec("relaxtpu_torch.models.swin3d") is not None:
    CALLS = ("relaxtpu_torch.models.swin3d", "window_mha")  # K4 as the backbone calls it
KERNEL = "window_mha_kernel"


def bound_s(qkv, grid, window, shift, heads, *_, **__):
    """(B, L, 3 C) bf16 over windows of N tokens: q, k, v read and o written
    once at the memory rate, or Q K^T and P V, 4 B H N^2 D operations over
    the windows (4 L H N D), at the bf16 peak."""
    b, tokens, c3 = qkv.shape
    d = c3 // 3 // heads
    return counts.bound_s(4.0 * b * tokens * heads * d * qkv.element_size(),
                          4.0 * b * tokens * heads * math.prod(window) * d, counts.PEAK_FLOPS["bf16"])


def read(ctx):
    return ctx.roofline("k4_roofline", KERNEL)
