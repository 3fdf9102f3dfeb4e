"""stage_device_ms.fragments_fastvqa: device milliseconds a stretch video of
the operations whose innermost program span at launch is
``relaxtpu.fragments`` in FAST-VQA's program: each mini-patch cropped out of
its converted region, flipped to RGB and laid into the mosaic
(``portbench/spans.py``).  The same span as ``stage_device_ms.fragments``,
under a name of its own for FAST-VQA's cells."""

from portbench import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "fragments")
