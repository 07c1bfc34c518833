"""mfu.serve: the model's forward FLOPs (counts/model.py, from the
configuration's shapes) times the batches of the traced window, over the
window and the bf16 peak, in percent."""


def read(ctx):
    if ctx.mode != "serve" or ctx.trace.window_s <= 0:
        return None
    flops = ctx.counts("model").forward_flops(ctx.records) * ctx.steps
    return 100.0 * flops / ctx.trace.window_s / ctx.peaks.BF16_FLOPS
