"""The FLOP and byte counts against hand counts."""
import pytest
import torch

from benchmark.counts import conv3x3, conv3x3_s8, model, roofline
from benchmark.harness import peaks
from benchmark.harness.layer_context import LayerContext
from benchmark.harness.spec import load_cell
from benchmark.harness.tasks import tracknet
from benchmark.harness.trace import TraceSummary


def rec(b, h, w, cin, cout, k=3, s=1, routed="conv3x3"):
    return ("conv", b, h, w, cin, cout, k, s, routed)


@pytest.mark.parametrize("r, ops, nbytes", [
    # TrackNet enc_1 at batch 32: 64 -> 64 at 352x640
    (rec(32, 352, 640, 64, 64), 2 * 32 * 352 * 640 * 64 * 64 * 9,
     2 * (32 * 352 * 640 * 64 + 9 * 64 * 64 + 32 * 352 * 640 * 64) + 4 * 64),
    # enc_0, served padded 16 -> 64: counted at the model's 9 frame channels
    (rec(32, 352, 640, 9, 64), 2 * 32 * 352 * 640 * 9 * 64 * 9,
     2 * (32 * 352 * 640 * 9 + 9 * 9 * 64 + 32 * 352 * 640 * 64) + 4 * 64),
    # dec_8, served 128 -> 128: the model's 126 -> 128 at 176x320
    (rec(32, 176, 320, 126, 128), 2 * 32 * 176 * 320 * 126 * 128 * 9,
     2 * (32 * 176 * 320 * 126 + 9 * 126 * 128 + 32 * 176 * 320 * 128) + 4 * 128),
])
def test_conv3x3_counts(r, ops, nbytes):
    assert conv3x3.ops(r) == ops
    assert conv3x3.bytes_moved(r) == nbytes


@pytest.mark.parametrize("r, ops, nbytes", [
    # TrackNet enc_1 in int8 at batch 32: s8 x and w, bf16 y, f32 bias and scales
    (rec(32, 352, 640, 64, 64, routed="conv3x3_s8"), 2 * 32 * 352 * 640 * 64 * 64 * 9,
     32 * 352 * 640 * 64 + 9 * 64 * 64 + 2 * 32 * 352 * 640 * 64 + 4 * 64 + 4 * 64),
    # dec_8 in int8, served 128 -> 128: the model's 126 -> 128 at 176x320
    (rec(32, 176, 320, 126, 128, routed="conv3x3_s8"), 2 * 32 * 176 * 320 * 126 * 128 * 9,
     32 * 176 * 320 * 126 + 9 * 126 * 128 + 2 * 32 * 176 * 320 * 128 + 4 * 128 + 4 * 128),
])
def test_conv3x3_s8_counts(r, ops, nbytes):
    assert conv3x3_s8.ops(r) == ops
    assert conv3x3_s8.bytes_moved(r) == nbytes
    assert conv3x3_s8.launches([r, rec(32, 352, 640, 64, 256)]) == [r]


def test_tracknet_int8_forward_counts_and_roofline():
    """17 s8 launches a batch (dec_13 stays bf16), bounded by the int8 peak."""
    cell = load_cell("tracknet_base.serve_int8_b32")
    records = tracknet._records(cell.config, 32, int8=True)
    s8 = conv3x3_s8.launches(records)
    assert len(s8) == 17 and conv3x3.launches(records) == [rec(32, 352, 640, 64, 256)]
    bound = sum(max(conv3x3_s8.ops(r) / 1979e12, conv3x3_s8.bytes_moved(r) / 3.35e12)
                for r in s8)
    assert bound == pytest.approx(6.1108e-3, rel=1e-3)  # PERF.md's TrackNet base s8 bound
    name = "void igemm::bias_act_kernel<signed char, 9, 128, 64, 8>(igemm::Params<signed char>)"
    ops = [(name, 0.0, 1e-3)] * 17 * 2 + [("other", 0.0, 5.0)]
    ctx = LayerContext(cell=cell, mode="serve", steps=2, trace=TraceSummary(1.0, 0.5, ops),
                       spans={}, records=records)
    got = roofline.share(ctx, conv3x3_s8, conv3x3_s8.PATTERN)
    assert got == pytest.approx(100 * 2 * bound / (34 * 1e-3))


def test_tracknet_forward_counts():
    cell = load_cell("tracknet_base.serve_b32")
    records = tracknet._records(cell.config, 32)
    launches = conv3x3.launches(records)
    assert len(launches) == 18 and len(records) == 18
    enc0 = [r for r in launches if r[4] == 9]
    assert enc0 == [rec(32, 352, 640, 9, 64)]
    assert [r for r in launches if r[4] == 126] == [rec(32, 176, 320, 126, 128)]
    flops = sum(2 * b * h * w * ci * co * 9 for _, b, h, w, ci, co, _, _, _ in records)
    assert model.forward_flops(records) == flops
    assert model.train_flops(records) == 3 * flops
    bound = sum(max(conv3x3.ops(r) / 989e12, conv3x3.bytes_moved(r) / 3.35e12)
                for r in launches)
    assert bound == pytest.approx(13.4742e-3, rel=1e-4)  # PERF.md's TrackNet serve bound


def test_roofline_share_sums_bounds_over_device_time():
    cell = load_cell("tracknet_base.serve_b32")
    records = [rec(2, 8, 8, 16, 16), rec(2, 8, 8, 16, 32), rec(2, 8, 8, 16, 16, k=1,
                                                              routed=None)]
    name = "void igemm::bias_act_kernel<__nv_bfloat16, 9, 128, 64, 8>(igemm::Params)"
    ops = [(name, 0.0, 1e-3), ("other", 0.0, 5.0), (name, 0.0, 3e-3)] * 2
    ctx = LayerContext(cell=cell, mode="serve", steps=2, trace=TraceSummary(1.0, 0.5, ops),
                       spans={}, records=records)
    bound = sum(max(conv3x3.ops(r) / peaks.BF16_FLOPS, conv3x3.bytes_moved(r) / peaks.HBM_BYTES)
                for r in records[:2])
    got = roofline.share(ctx, conv3x3, r"bias_act_kernel<__nv_bfloat16, 9,")
    assert got == pytest.approx(100 * 2 * bound / 8e-3)
    # a launch count other than the counts' (another routing) reads nothing
    ctx.steps = 3
    assert roofline.share(ctx, conv3x3, r"bias_act_kernel<__nv_bfloat16, 9,") is None
