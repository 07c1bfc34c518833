"""The int8 serve form at the tiny size on the CPU: the port's int8
TrackNet base forward (`quantize_model_int8`; float32 and exact f64 sums on
the CPU) against the int8 scheme written out in plain PyTorch
(reference/int8.py), the control with every activation scale times 4 read
apart from both, and the int8 cell's comparison: a sound run is correct;
the control and every fault the timed path can have are not."""
import pytest
import torch

from benchmark.harness import main as harness
from benchmark.harness import seeded
from benchmark.harness.compare import judge
from benchmark.harness.tasks import tracknet
from benchmark.reference.int8 import Int8Net
from benchmark.tests.tiny import tiny_cell
from vision_conglomerate_torch.infer.runner import quantize_model_int8
from vision_conglomerate_torch.models import TrackNet
from vision_conglomerate_torch.nn.reparam import deploy_transform

CPU = torch.device("cpu")
INT8 = "tracknet_base.serve_int8_b32"
# Each tolerance is in units of the reference logits' standard deviation.
# The port and the reference fold, calibrate and sum the float convs in
# float32 in different orders, so an activation scale differs by about
# 1e-6 of itself (the scales are compared to 1e-5), and now and then an
# x_q near a rounding tie flips by one and moves the logits downstream of
# it: the widest gap read 0.43 and the mean 2.1e-3 over seeds 3, 7, 11
# and 2**31 + 5, against the control's widest 8.0-11.7 and mean 0.41.
MEAN_TOL, MAX_TOL = 1e-2, 1.5
CONTROL_MEAN_MIN = 0.2


def _port(cell, state, calib, factor=1):
    model = TrackNet(cell.config["model_config"], in_channels=9, folded=True)
    model.load_state_dict(deploy_transform(state, fuse_repvgg=False))
    quantize_model_int8(model.eval(), calib)
    if factor != 1:
        tracknet.coarsen_activations(model, factor)
    return model


def _gaps(a, b):
    sd = float(b.std())
    d = (a - b).abs()
    return float(d.mean()) / sd, float(d.max()) / sd


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_the_port_int8_forward_matches_the_int8_reference(seed):
    cell = tiny_cell(INT8)
    state, _ = tracknet.serve_state(cell.config, seed, CPU, 2)
    calib = seeded.frames_f32((4, 32, 64, 9), seed, CPU).permute(0, 3, 1, 2)
    x = seeded.frames_f32((3, 32, 64, 9), seed + 1, CPU).permute(0, 3, 1, 2)
    ref = tracknet._reference(cell.config, seed, CPU, state).eval()
    int8_ref = Int8Net(ref, calib, torch.float32)
    port = _port(cell, state, calib)
    scales = [float(m.q_xscale) for m in port.modules() if hasattr(m, "q_xscale")]
    assert scales == pytest.approx([s for s in int8_ref.scales() if s is not None], rel=1e-5)
    control = _port(cell, state, calib, factor=tracknet.INT8_CONTROL_FACTOR)
    control_ref = Int8Net(ref, calib, torch.float32, act_scale=tracknet.INT8_CONTROL_FACTOR)
    with torch.no_grad():
        want = int8_ref(x)
        mean, widest = _gaps(port(x), want)
        assert mean <= MEAN_TOL and widest <= MAX_TOL
        # the control, in the program or in the reference, reads apart from both
        for low in (control(x), control_ref(x)):
            assert _gaps(low, want)[0] >= CONTROL_MEAN_MIN
            assert _gaps(low, port(x))[0] >= CONTROL_MEAN_MIN


def test_the_int8_records_route_the_batchnorm_convs_to_the_s8_kernel():
    cell = tiny_cell(INT8)
    records = tracknet._records(cell.config, 4, int8=True)
    assert [r[8] for r in records] == ["conv3x3_s8"] * 17 + ["conv3x3"]
    assert [r[:8] for r in records] == [r[:8] for r in tracknet._records(cell.config, 4)]


def correct(cell, seed, **opts) -> bool:
    res = harness.run_job(cell, seed, 0.01, False, CPU, **opts)
    return judge(res["numbers"], cell.limits)[0]


@pytest.mark.parametrize("opts, ok", [
    ({}, True),
    ({"control": tracknet.INT8_CONTROL}, False),
    ({"fault": "half_batch"}, False),
    ({"fault": "stale"}, False),
    ({"fault": "altered"}, False),
])
def test_the_int8_cell_judges_sound_runs_controls_and_faults(opts, ok):
    assert correct(tiny_cell(INT8), 2 ** 31 + 11, **opts) is ok


def test_the_int8_cell_notes_its_gap_against_the_float32_reference():
    res = harness.run_job(tiny_cell(INT8), 5, 0.01, False, CPU)
    assert set(res["numbers"]) == {"heatmap_gap", "heatmap_gap_f32"}
    assert res["numbers"]["heatmap_gap_f32"] > res["numbers"]["heatmap_gap"]
