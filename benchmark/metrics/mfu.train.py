"""mfu.train: three forwards' FLOPs a step at this card's batch
(counts/model.py) times the steps of the traced window, over the window
and one card's bf16 peak, in percent."""


def read(ctx):
    if ctx.mode != "train" or ctx.trace.window_s <= 0:
        return None
    flops = ctx.counts("model").train_flops(ctx.records) * ctx.steps
    return 100.0 * flops / ctx.trace.window_s / ctx.peaks.BF16_FLOPS
