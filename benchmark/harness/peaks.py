"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the denominators of every roofline share and MFU."""
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES = 3.35e12
