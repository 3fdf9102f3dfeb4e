"""flow_device_ms: device milliseconds a video of the work launched inside
``farneback_flow`` (as the pipeline calls it), over the stretch's videos."""

CALLS = ("relaxtpu_torch.features.pipeline", "farneback_flow")


def read(ctx):
    return ctx.device_ms_per_video("flow_device_ms")
