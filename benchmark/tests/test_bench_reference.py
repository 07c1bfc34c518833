"""The frozen reference against the port at a tiny size on the CPU (the
port's kernels run their plain versions there): the same seeded weights,
the port's deploy form (folded, channel-padded) against the reference's
unfolded eval form, and a train step against the reference's."""
import pytest
import torch

from benchmark.harness import seeded
from benchmark.harness.tasks import tracknet
from benchmark.reference.train import first_steps
from benchmark.tests.tiny import tiny_cell
from vision_conglomerate_torch.models import TrackNet
from vision_conglomerate_torch.nn import blocks
from vision_conglomerate_torch.nn.reparam import deploy_transform

CPU = torch.device("cpu")


def test_state_dict_keys_and_shapes_agree():
    cell = tiny_cell("tracknet_base.serve_b32")
    port = TrackNet(cell.config["model_config"], in_channels=9).state_dict()
    ref = tracknet._reference(cell.config, 1, CPU).state_dict()
    assert {k: v.shape for k, v in port.items()} == {k: v.shape for k, v in ref.items()}


def _count_launches(monkeypatch):
    counts = {"conv3x3": 0}

    def wrap(fn, name):
        def counted(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(blocks, "conv3x3_bias_act", wrap(blocks.conv3x3_bias_act, "conv3x3"))
    return counts


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_tracknet_deploy_form_matches_reference(seed, monkeypatch):
    cell = tiny_cell("tracknet_base.serve_b32")
    state, records = tracknet.serve_state(cell.config, seed, CPU, 2)
    port = TrackNet(cell.config["model_config"], in_channels=9, folded=True)
    port.load_state_dict(deploy_transform(state, fuse_repvgg=False))
    port.eval()
    ref = tracknet._reference(cell.config, seed, CPU, state).eval()
    x = seeded.frames_f32((2, 32, 64, 9), seed, CPU).permute(0, 3, 1, 2)
    counts = _count_launches(monkeypatch)
    with torch.no_grad():
        got = port(x)
        want = ref(x.contiguous())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert counts["conv3x3"] == len([r for r in records if r[8] == "conv3x3"]) == 18
    assert records == tracknet._records(cell.config, 2)


def test_train_steps_match_reference():
    from benchmark.harness.tasks.tracknet import Train

    cell = tiny_cell("tracknet_base.train_b16")
    job = Train(cell, 9, CPU)
    ref = first_steps(tracknet._reference(cell.config, 9, CPU),
                      [(job.frames[k], job.heat[k]) for k in range(3)], job.opt_cfg)
    assert job.readings["losses"] == pytest.approx(ref["losses"], rel=1e-5)
    for k, g in ref["grad"].items():
        if g > 1e-6:
            assert job.readings["grad"][k] == pytest.approx(g, rel=1e-4), k
