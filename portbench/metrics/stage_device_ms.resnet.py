"""stage_device_ms.resnet: device milliseconds a stretch video of the
operations whose innermost program span at launch is ``relaxtpu.resnet``:
the ResNet-50 forward (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "resnet")
