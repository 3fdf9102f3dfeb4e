"""stage_device_ms.colorspace: device milliseconds a stretch video of the
operations whose innermost program span at launch is ``relaxtpu.colorspace``:
I420 -> BGR of the frames and of each chunk's successor frames (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "colorspace")
