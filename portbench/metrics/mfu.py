"""mfu: the model step's share (%) of the card's dense peak for the
configuration's type: ResNet-50 and ViT-B/16 forward operations of the
stretch's videos (F + 2 P images each, counted from shapes), over the
profiled stretch's seconds."""


def read(ctx):
    if ctx.trace is None or not ctx.stretch_videos:
        return None
    return 100.0 * ctx.stretch_videos * ctx.video_flops / ctx.trace.window_s / ctx.peak_flops
