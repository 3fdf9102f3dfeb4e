"""backbone_device_ms: device milliseconds a video of the work launched
inside the ResNet-50 and ViT forwards, over the stretch's videos."""

HOOKS = ("resnet", "vit")  # the extractor's networks


def read(ctx):
    return ctx.device_ms_per_video("backbone_device_ms")
