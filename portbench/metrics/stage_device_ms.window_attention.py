"""stage_device_ms.window_attention: device milliseconds a stretch video of
the operations whose innermost program span at launch is
``relaxtpu.window_attention``: K4, the shifted-window attention of
FAST-VQA's backbone (``portbench/spans.py``).  A program without the span
reads nothing."""

from portbench import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "window_attention")
