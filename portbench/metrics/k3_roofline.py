"""k3_roofline: K3's share (%) of its roofline: the least time of its calls
over the device time of their kernel records.  Only calls whose record the
profiler kept count, each with its own work."""

from portbench import counts

CALLS = ("relaxtpu_torch.models.vit", "mha")  # K3 as the ViT calls it
KERNEL = "mha_"


def bound_s(q, k, v, scale):
    """(B, N, H, D) attention: q, k, v read and o written once at the
    memory rate, or QK^T and PV, 4 B H N^2 D operations, at the type's peak."""
    b, n, h, d = q.shape
    dtype = "bf16" if str(q.dtype).endswith("bfloat16") else "f32"
    return counts.bound_s(4.0 * b * n * h * d * q.element_size(), 4.0 * b * h * n * n * d, counts.PEAK_FLOPS[dtype])


def read(ctx):
    return ctx.roofline("k3_roofline", KERNEL)
