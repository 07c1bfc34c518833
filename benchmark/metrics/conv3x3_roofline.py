"""conv3x3_roofline: the port's conv3x3 kernel (csrc/conv3x3_bias_act.cu,
the bf16 instance of igemm_sm90.cuh with nine taps) against its roofline
over the traced window (counts/roofline.py), in percent."""
PATTERN = r"bias_act_kernel<__nv_bfloat16, 9,"


def read(ctx):
    return ctx.counts("roofline").share(ctx, ctx.counts("conv3x3"), PATTERN)
