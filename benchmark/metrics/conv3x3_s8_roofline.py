"""conv3x3_s8_roofline: the port's s8 conv3x3 kernel
(csrc/conv3x3_s8_bias_act.cu, the int8 instance of igemm_sm90.cuh with
nine taps) against its roofline over the traced window
(counts/roofline.py, counts/conv3x3_s8.py: the int8 peak), in percent."""


def read(ctx):
    counts = ctx.counts("conv3x3_s8")
    return ctx.counts("roofline").share(ctx, counts, counts.PATTERN)
