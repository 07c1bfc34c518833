"""A cell, configuration, traffic mix, limits, metric and task added as
files are found by name, with no edit to any file of the harness."""
import hashlib
import importlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness.layer_context import LayerContext, read_metrics
from benchmark.harness.spec import ROOT, load_cell
from benchmark.harness.trace import TraceSummary


def _copy_bench(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    return tmp_path


def test_every_cell_of_the_benchmark_loads():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in spec["workloads"]:
        cell = load_cell(w["name"])
        task = importlib.import_module(f"benchmark.harness.tasks.{cell.config['task']}")
        assert callable(task.make_job) and callable(task.calibration)
        assert cell.limits and cell.end_to_end and cell.per_layer
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        for m in cell.per_layer:
            assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))


def test_throwaway_cell_config_traffic_and_metric_are_found(tmp_path):
    root = _copy_bench(tmp_path)
    bench = root / "benchmark"
    (bench / "configs" / "toy.yaml").write_text(
        (bench / "configs" / "tracknet_base.yaml").read_text())
    (bench / "traffic" / "serve_b8.json").write_text(json.dumps(
        {"mode": "serve", "batch": 8, "og_hw": [720, 1280], "ring": 2, "sample_steps": 4,
         "sample_rows": 2, "calibration_rows": 2}))
    (bench / "limits" / "toy.serve_b8.json").write_text(json.dumps({"heatmap_gap": 3.0}))
    (bench / "metrics" / "toy.steps.py").write_text("def read(ctx):\n    return ctx.steps\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy", "source": "https://example.org/toy",
                            "file": "benchmark/configs/toy.yaml", "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": "toy.serve_b8", "config": "toy", "traffic": "serve_b8",
                              "chips": 1, "why": "toy"})
    spec["per_layer"].append({"name": "toy.steps", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "toy",
                              "moves": "serve_img_per_s", "workloads": ["toy.serve_b8"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "tracknet_base.serve_b32" in m["workloads"]:
            m["workloads"].append("toy.serve_b8")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = load_cell("toy.serve_b8", root=str(root))
    assert cell.traffic["batch"] == 8 and cell.limits == {"heatmap_gap": 3.0}
    assert [m["name"] for m in cell.per_layer] == ["toy.steps"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "serve_img_per_s"}
    ctx = LayerContext(cell=cell, mode="serve", steps=7, trace=TraceSummary(1.0, 0.5),
                       spans={}, records=[])
    assert read_metrics(cell, ctx) == {"toy.steps": {"value": 7, "unit": "steps"}}


def test_a_reader_that_finds_nothing_is_left_out():
    cell = load_cell("tracknet_base.serve_b32")
    ctx = LayerContext(cell=cell, mode="serve", steps=3, trace=TraceSummary(1.0, 0.0),
                       spans={}, records=[])
    out = read_metrics(cell, ctx)
    assert "conv3x3_roofline" not in out and "serve.forward_ms" not in out
    assert "mfu.serve" in out


def test_the_data_parallel_cell_reads_its_own_names_of_the_train_metrics():
    """The four-card cell reports ddp_train_img_per_s, and its per-layer
    metrics read what the one-card cell's do, under names that move it."""
    one = load_cell("tracknet_base.train_b16")
    ddp = load_cell("tracknet_base.train_ddp4_b64")
    assert {m["name"] for m in one.end_to_end} == {"train_img_per_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in ddp.end_to_end} == {"ddp_train_img_per_s", "peak_mem_gib",
                                                   "setup_s"}
    assert {m["moves"] for m in ddp.per_layer} == {"ddp_train_img_per_s"}
    ops = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 0.0,
            4e-3),
           ("nccl:all_reduce", 0.0, 4e-3),  # the profiler's annotation of that kernel
           ("ncclDevKernel_AllReduce_Max_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 0.0,
            1e-3),  # the benchmark's stop flag
           ("sm90_xmma_fprop_implicit_gemm_bf16bf16", 0.0, 0.1)]
    trace = TraceSummary(2.0, 1.9, ops, {"aten::cudnn_convolution": 0.4,
                                          "aten::convolution_backward": 0.6})
    records = [("conv", 16, 8, 8, 16, 16, 3, 1, "conv3x3")]
    ctx = LayerContext(cell=ddp, mode="train", steps=10, trace=trace,
                       spans={"optimizer": [0.5, 0.7]}, records=records)
    got = read_metrics(ddp, ctx)
    pairs = {"ddp.cudnn_conv_ms": "train.cudnn_conv_ms", "ddp.optimizer_ms": "train.optimizer_ms",
             "mfu.ddp": "mfu.train", "device.idle.ddp": "device.idle.train"}
    ref = read_metrics(one, ctx)
    for mine, theirs in pairs.items():
        assert got[mine]["value"] == pytest.approx(ref[theirs]["value"])
    assert got["ddp.cudnn_conv_ms"]["value"] == pytest.approx(100.0)
    assert got["ddp.allreduce_ms"]["value"] == pytest.approx(0.4)


def test_metric_without_workloads_goes_to_every_cell_reporting_what_it_moves(tmp_path):
    root = _copy_bench(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "device.idle.train", "unit": "%", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "train_img_per_s"})
    spec["per_layer"] = [m for m in spec["per_layer"] if m["name"] != "device.idle.train"
                         or "workloads" not in m]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    train = load_cell("tracknet_base.train_b16", root=str(root))
    serve = load_cell("tracknet_base.serve_b32", root=str(root))
    assert "device.idle.train" in {m["name"] for m in train.per_layer}
    assert "device.idle.train" not in {m["name"] for m in serve.per_layer}


TOY_TASK = """
import math


class Job:
    items_per_step, records = 2, []

    def __init__(self, cell, seed, device, control=None, fault=None):
        self.off = {None: 0.0, "coarse": 5.0}[control] + (10.0 if fault else 0.0)

    def step(self, i):
        pass

    def spans(self, on):
        pass

    def span_ms(self):
        return {}

    def release(self):
        pass

    def check(self, witness=False):
        return {"toy_gap": self.off + (0.5 if witness else 0.1)}


def make_job(mode, cell, seed, device, **opts):
    return Job(cell, seed, device, **opts)


def calibration(cell):
    return {"control": [("control_coarse", {"control": "coarse"})],
            "witness": [("witness_toy", {"witness": True})],
            "faults": [("fault_lost", {"fault": "lost"}),
                       ("fault_reference", lambda seed, device: {"toy_gap": float(seed)})]}
"""

PROBE = """
import json, sys
sys.path.insert(0, ".")
import torch
from benchmark import calibrate
from benchmark.harness.main import end_to_end
from benchmark.harness.spec import load_cell
cell = load_cell("toy_net.serve_b2")
res = {"setup_s": 1.0, "window_s": 2.0, "items": 8, "peak_bytes": 0, "latencies_ms": [1.0]}
steps = calibrate.plan(cell, ["program", "control", "witness", "faults"])
out = {"task": cell.config["task"], "end_to_end": sorted(end_to_end(cell, res)),
       "readings": [[kind, calibrate.read(cell, 7, how, torch.device("cpu"), 0.01)["numbers"]]
                    for kind, how in steps]}
print(json.dumps(out))
"""


def _digests(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def test_a_configuration_of_a_new_task_is_added_as_new_files_alone(tmp_path):
    """A throwaway task, its configuration, traffic, limits and cell, added
    as new files in a copy of the benchmark (and entries in BENCHMARK.json):
    the cell loads, reports the end-to-end metrics whose lists name it, and
    calibrate.py's dispatch reads the task's own control, witness and faults;
    no file that was there changes."""
    root = _copy_bench(tmp_path)
    bench = root / "benchmark"
    before = _digests(bench)
    (bench / "harness" / "tasks" / "toy_task.py").write_text(TOY_TASK)
    (bench / "configs" / "toy_net.yaml").write_text("task: toy_task\nreduced: []\n")
    (bench / "traffic" / "serve_b2.json").write_text(json.dumps({"mode": "serve", "batch": 2}))
    (bench / "limits" / "toy_net.serve_b2.json").write_text(json.dumps({"toy_gap": 1.0}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy_net", "source": "https://example.org/toy",
                            "file": "benchmark/configs/toy_net.yaml", "reduced": [],
                            "why": "toy"})
    spec["workloads"].append({"name": "toy_net.serve_b2", "config": "toy_net",
                              "traffic": "serve_b2", "chips": 1, "why": "toy"})
    for m in spec["end_to_end"]:
        if m["name"] == "serve_img_per_s":
            m["workloads"].append("toy_net.serve_b2")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    out = subprocess.run([sys.executable, "-c", PROBE], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["task"] == "toy_task"
    assert got["end_to_end"] == ["peak_mem_gib", "serve_img_per_s", "setup_s"]
    assert got["readings"] == [["program", {"toy_gap": 0.1}],
                               ["control_coarse", {"toy_gap": 5.1}],
                               ["witness_toy", {"toy_gap": 0.5}],
                               ["fault_lost", {"toy_gap": 10.1}],
                               ["fault_reference", {"toy_gap": 7.0}]]
    after = _digests(bench)
    assert {k: after[k] for k in before} == before
