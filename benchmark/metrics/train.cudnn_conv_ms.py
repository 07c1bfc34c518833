"""train.cudnn_conv_ms: device time a step of the kernels that cuDNN's
convolutions launch, forward (`aten::cudnn_convolution`) and backward
(`aten::convolution_backward`), from the ops' own device time in the
trace."""
OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def read(ctx):
    s = sum(v for k, v in ctx.trace.op_self_device_s.items() if k in OPS)
    return 1e3 * s / ctx.steps if s > 0 and ctx.steps else None
