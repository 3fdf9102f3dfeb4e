"""stage_device_ms.upload: device milliseconds a stretch video of the
operations whose innermost program span at launch is ``relaxtpu.upload``:
host staging into pinned memory and the copy to the device (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "upload")
