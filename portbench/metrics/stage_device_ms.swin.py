"""stage_device_ms.swin: device milliseconds a stretch video of the
operations whose innermost program span at launch is ``relaxtpu.swin``:
FAST-VQA's normalisation and Video Swin-T backbone outside K4 (the
projections, MLPs, LayerNorms, patch embedding and mergings;
``portbench/spans.py``).  A program without the span reads nothing."""

from portbench import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "swin")
