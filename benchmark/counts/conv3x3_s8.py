"""Operations and bytes of one launch of the s8 conv3x3 kernel
(csrc/conv3x3_s8_bias_act.cu, the int8 instance of igemm_sm90.cuh with nine
taps): act(float(conv3x3(x_q, w_q; stride 1, pad 1)) * scale + b), from a
conv record (reference/layers.py) that reference/int8.mark_routes named
"conv3x3_s8", at the model's own channels (a channel-padded launch counts
the model's work): 2 * 9 * Cin * Cout integer operations a pixel, against
the int8 peak; the s8 x and w read once, the bf16 y written once, the f32
bias and the f32 scales read once."""
KERNEL = "conv3x3_s8"
PEAK = "INT8_OPS"
# the kernel's name in the profiler's trace (int8_t demangles as signed char)
PATTERN = r"bias_act_kernel<signed char, 9,"


def ops(rec) -> float:
    _, b, h, w, cin, cout, _, _, _ = rec
    return 2.0 * b * h * w * cin * cout * 9


def bytes_moved(rec) -> float:
    _, b, h, w, cin, cout, _, _, _ = rec
    return b * h * w * cin + 9 * cin * cout + 2.0 * b * h * w * cout + 4.0 * 2 * cout


def launches(records):
    return [r for r in records if r[8] == KERNEL]
