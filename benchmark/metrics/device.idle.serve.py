"""device.idle.serve: the share of the traced window in which no
operation ran on the device (the union of the trace's device intervals
is the busy time), in percent."""


def read(ctx):
    if ctx.mode != "serve" or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
