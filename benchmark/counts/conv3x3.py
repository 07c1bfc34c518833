"""Operations and bytes of one launch of the conv3x3 kernel, act(conv3x3(x,
w; stride 1, pad 1) + b) in bf16, from a conv record (reference/layers.py)
at the model's own channels (a channel-padded launch counts the model's
work): 2 * 9 * Cin * Cout MACs a pixel; x, w and y read or written once,
the f32 bias once."""
KERNEL = "conv3x3"
PEAK = "BF16_FLOPS"
BYTES = 2


def ops(rec) -> float:
    _, b, h, w, cin, cout, _, _, _ = rec
    return 2.0 * b * h * w * cin * cout * 9


def bytes_moved(rec) -> float:
    _, b, h, w, cin, cout, _, _, _ = rec
    return BYTES * (b * h * w * cin + 9 * cin * cout + b * h * w * cout) + 4.0 * cout


def launches(records):
    return [r for r in records if r[8] == KERNEL]
