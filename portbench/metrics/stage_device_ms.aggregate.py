"""stage_device_ms.aggregate: device milliseconds a stretch video of the
operations whose innermost program span at launch is ``relaxtpu.aggregate``:
the ResNet taps' statistics, the fragment rows, the means and sums (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "aggregate")
