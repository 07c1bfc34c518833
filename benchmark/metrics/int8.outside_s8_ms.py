"""int8.outside_s8_ms: device ms a batch of the int8 forward outside the s8
conv kernel: the program's spans `tracknet.encoder` and `tracknet.decoder`
in a `serve.batch` (the means over the traced window), less the s8 conv
launches' device time a batch. What is left is the activation quantize
passes, the pools, the upsampling and the concatenations, dec_13's bf16
conv and the idle inside the two spans."""
import re

from benchmark.harness import program_spans


def read(ctx):
    enc = program_spans.mean_ms(ctx, "tracknet.encoder", "serve.batch")
    dec = program_spans.mean_ms(ctx, "tracknet.decoder", "serve.batch")
    counts = ctx.counts("conv3x3_s8")
    rx = re.compile(counts.PATTERN)
    s8 = [d for name, _, d in ctx.trace.device_ops if rx.search(name)]
    per_step = counts.launches(ctx.records)
    if enc is None or dec is None or not per_step or len(s8) != len(per_step) * ctx.steps:
        return None
    return enc + dec - 1e3 * sum(s8) / ctx.steps
