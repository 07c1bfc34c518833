"""The port's three train CLIs with `--use_ddp` on two gloo ranks, started
as torchrun starts them (tests/test_torch_ddp.start_ranks), on the CPU.

Each rank runs `python -m vision_conglomerate_torch.<cli> --use_ddp` in
a workspace of its own (the data shared, by absolute path) for one epoch
at a global batch of 4; the three CLIs' groups run at once. Only rank 0
writes: its workspace holds the metrics CSVs, plots, best model, snapshot
and config copies, rank 1's none of them, and rank 1's anchors file is
left as it was (the auto-anchors run on rank 0 and are broadcast). The lr
in the snapshot's optimizer state is the config's times 2, the number of
ranks.
"""
import hashlib
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import yaml

from test_torch_ddp import N_RANKS, finish_ranks, start_ranks


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _start_cli(tmp, module, config, argv, anchors=None):
    """Each rank's workspace tmp/rank<r> with config.yaml (and a copy of
    `anchors`), and the CLI started there on its rank. Returns (the
    workspaces, the processes)."""
    workspaces = []
    for r in range(N_RANKS):
        ws = os.path.join(tmp, f"rank{r}")
        os.makedirs(ws)
        with open(os.path.join(ws, "config.yaml"), "w") as f:
            yaml.safe_dump(config, f)
        if anchors:
            shutil.copy(anchors, os.path.join(ws, "anchors.yaml"))
        workspaces.append(ws)
    cli = ["--use_ddp", "--config_path", "config.yaml", "--batch_size", "4", "--epochs", "1",
           "--checkpoint_interval", "1", "--no_verbose", "--device", "cpu", *argv]
    code = (f"import runpy, sys; sys.argv = ['{module}'] + {cli!r}; "
            f"runpy.run_module('vision_conglomerate_torch.{module}', run_name='__main__')")
    return workspaces, start_ranks(code, cwd=workspaces)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """train_det (with --map_eval), train_seg and train_tracknet, each on
    two ranks, all six processes at once."""
    from tests.test_torch_seg_data import write_polygon_dataset
    from tests.test_torch_seg_train import SIZE, _workspace
    from tests.test_torch_tracknet_serve import TRAIN_CONFIG
    from tests.test_torch_train_cli import CONFIG, REPO_ANCHORS, _write_dataset
    from tests.test_tracknet import _write_clip

    tmp = tmp_path_factory.mktemp("ddp_cli")
    det, seg, tn = (tmp / t for t in ("det", "seg", "tn"))
    _write_dataset(str(det / "data" / "train"), 4)
    _write_dataset(str(det / "data" / "valid"), 2, seed=1)
    det_config = {**CONFIG, "train_config": {**CONFIG["train_config"],
                                             "data_path": str(det / "data")}}
    write_polygon_dataset(str(seg / "data" / "train"), n=4, size=(SIZE, SIZE), seed=1,
                          max_polygons=4)
    write_polygon_dataset(str(seg / "data" / "valid"), n=2, size=(SIZE, SIZE), seed=2,
                          max_polygons=4)
    (seg / "template").mkdir()
    seg_config = _workspace(str(seg / "template"), seg / "data")
    _write_clip(str(tn / "data"), n_frames=13)
    tn_config = {**TRAIN_CONFIG, "train_config": {**TRAIN_CONFIG["train_config"],
                                                  "data_path": str(tn / "data")}}
    started = {
        "detection": _start_cli(str(det), "train_det", det_config,
                                ["--anchors_path", "anchors.yaml", "--map_eval"], REPO_ANCHORS),
        "segmentation": _start_cli(str(seg), "train_seg", seg_config,
                                   ["--anchors_path", "anchors.yaml"],
                                   str(seg / "template" / "anchors.yaml")),
        "tracknet": _start_cli(str(tn), "train_tracknet", tn_config, []),
    }
    try:
        for _, procs in started.values():
            finish_ranks(procs)
    finally:
        for _, procs in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    lrs = {"detection": det_config, "segmentation": seg_config, "tracknet": tn_config}
    anchors = {"detection": _sha(REPO_ANCHORS),
               "segmentation": _sha(str(seg / "template" / "anchors.yaml")), "tracknet": None}
    return {task: dict(workspaces=ws, anchors=anchors[task],
                       lr=lrs[task]["train_config"]["optimizer_config"]["lr"])
            for task, (ws, _) in started.items()}


def _check_only_rank0_wrote(run, task, model):
    from vision_conglomerate_torch.train.checkpoint import load_checkpoint

    ws0, ws1 = run["workspaces"]
    for rel in (f"metrics/{task}/train_metrics.csv", f"metrics/{task}/eval_metrics.csv",
                f"metrics/{task}/train_metrics_plot.jpg",
                f"saved_model/{task}/best_model/{model}.ckpt.tar",
                f"saved_model/{task}/best_model/config/config.yaml"):
        assert os.path.isfile(os.path.join(ws0, rel)), rel
    snaps = [os.path.join(r, f) for r, _, fs in os.walk(os.path.join(ws0, "saved_model", task,
                                                                     "checkpoints"))
             for f in fs if f.endswith(".ckpt.tar")]
    assert len(snaps) == 1
    assert sorted(os.listdir(ws1)) == sorted(["config.yaml"] + (["anchors.yaml"]
                                                                if run["anchors"] else []))
    if run["anchors"]:
        assert _sha(os.path.join(ws1, "anchors.yaml")) == run["anchors"]
    groups = load_checkpoint(snaps[0])["TORCH_OPTIMIZER_PARAMS"]["param_groups"]
    assert groups[0]["lr"] == pytest.approx(run["lr"] * N_RANKS, rel=1e-12)
    loss = pd.read_csv(os.path.join(ws0, f"metrics/{task}/train_metrics.csv")).iloc[:, 0]
    assert np.isfinite(loss).all()
    return ws0


def test_train_det_use_ddp(runs):
    ws0 = _check_only_rank0_wrote(runs["detection"], "detection", "DetectionNet")
    ev = pd.read_csv(os.path.join(ws0, "metrics/detection/eval_metrics.csv"))
    assert "map50" in ev.columns


def test_train_seg_use_ddp(runs):
    _check_only_rank0_wrote(runs["segmentation"], "segmentation", "SegmentationNet")


def test_train_tracknet_use_ddp(runs):
    _check_only_rank0_wrote(runs["tracknet"], "tracknet", "TrackNet")
