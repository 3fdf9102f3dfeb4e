"""k2_roofline: K2's share (%) of its roofline: the least time of its calls
over the device time of their kernel records.  Only calls whose records the
profiler kept count, each with its own work."""

from portbench import counts

CALLS = ("relaxtpu_torch.ops.flow", "box_blur_solve")  # K2 as the flow calls it
KERNEL = "box_"


def bound_s(m, winsize=15):
    """M (P, 5, H, W): 7 f32 a pixel (M read, the flow written) at the
    memory rate, or the adds of the box sums (5 planes x 2 (winsize - 1))
    plus 15 for the scaling and the 2x2 solve a pixel at the add rate."""
    p, _, h, w = m.shape
    px = p * h * w
    return counts.bound_s(px * 7 * 4, px * (10 * (winsize - 1) + 15), counts.F32_ADDS_PER_S)


def read(ctx):
    return ctx.roofline("k2_roofline", KERNEL)
