"""device.idle.train: the share of the traced window in which no
operation ran on the device (rank 0's in a cell over several chips), in
percent."""


def read(ctx):
    if ctx.mode != "train" or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
