"""k1_roofline: K1's share (%) of its roofline: the least time of its calls
over the device time of their kernel records.  Only calls whose record the
profiler kept count, each with its own work."""

from portbench import counts

CALLS = ("relaxtpu_torch.ops.flow", "update_matrices")  # K1 as the flow calls it
KERNEL = "update_matrices_kernel"


def bound_s(r0, r1, flow):
    """P pairs of H x W: 17 f32 a pixel (r0 and r1 read, the flow read, M
    written) at the memory rate, or 80 operations a pixel (corner weights,
    5-plane gather, averaging, flow terms, taper, products) at the f32 peak."""
    p, _, h, w = flow.shape
    px = p * h * w
    return counts.bound_s(px * 17 * 4, px * 80, counts.PEAK_FLOPS["f32"])


def read(ctx):
    return ctx.roofline("k1_roofline", KERNEL)
