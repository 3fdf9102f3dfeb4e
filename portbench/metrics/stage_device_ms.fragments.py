"""stage_device_ms.fragments: device milliseconds a stretch video of the
operations whose innermost program span at launch is ``relaxtpu.fragments``:
residuals, patch ranking, gathers, grey, the flow image and the merge, outside the flow (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "fragments")
