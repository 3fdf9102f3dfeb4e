"""stage_device_ms.vit: device milliseconds a stretch video of the
operations whose innermost program span at launch is ``relaxtpu.vit``:
the ViT forward (K3 and its statistics) (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "vit")
