"""stage_device_ms.flow: device milliseconds a stretch video of the
operations whose innermost program span at launch is ``relaxtpu.flow``:
the Farneback flow (``farneback_flow``: pyramid, expansion, K1, K2) (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "flow")
