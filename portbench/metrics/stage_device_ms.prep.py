"""stage_device_ms.prep: device milliseconds a stretch video of the
operations whose innermost program span at launch is ``relaxtpu.prep``:
the backbones' resize, quantisation, normalisation and cast (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "prep")
