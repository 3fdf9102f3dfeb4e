"""host_enqueue_ms: host milliseconds of one ``video_feature_async_i420``
call (upload staging, launches), the mean over the traced run's videos
outside the profiled stretch."""


def read(ctx):
    return sum(ctx.enqueue_ms) / len(ctx.enqueue_ms) if ctx.enqueue_ms else None
