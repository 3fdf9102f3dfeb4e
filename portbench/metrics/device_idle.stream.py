"""device_idle: the share (%) of the profiled stretch in which no device
operation (kernel, copy, set) ran: the union of their intervals, merged."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
