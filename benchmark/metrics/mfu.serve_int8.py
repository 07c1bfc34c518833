"""mfu.serve_int8: the model's forward operations (counts/model.py, from
the configuration's shapes) times the batches of the traced window, over
the window and the int8 peak, in percent: the whole int8 step's share."""


def read(ctx):
    if ctx.mode != "serve" or ctx.trace.window_s <= 0:
        return None
    ops = ctx.counts("model").forward_flops(ctx.records) * ctx.steps
    return 100.0 * ops / ctx.trace.window_s / ctx.peaks.INT8_OPS
