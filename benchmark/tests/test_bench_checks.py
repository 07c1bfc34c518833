"""The comparison that decides `correct`, at the tiny size on the CPU,
held to each cell's own limits: a sound run is correct; the control and
every fault the timed path can have come out not correct. A run here
skips the harness's look for a card and drives the rest of a run with the
timed path broken underneath (`fault`)."""
import io
import json
import multiprocessing
import os
import socket
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from benchmark.harness import main as harness
from benchmark.harness.compare import judge
from benchmark.harness.spec import ROOT
from benchmark.harness.tasks.tracknet import Train
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SERVE = ["tracknet_base.serve_b32"]


def correct(cell, seed, **opts) -> bool:
    res = harness.run_job(cell, seed, 0.01, False, CPU, **opts)
    return judge(res["numbers"], cell.limits)[0]


@pytest.mark.parametrize("name", SERVE + ["tracknet_base.train_b16"])
def test_a_sound_run_is_correct(name):
    assert correct(tiny_cell(name), 2 ** 31 + 11)


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", ["half_batch", "stale", "altered"])
def test_serve_faults_are_not_correct(name, fault):
    assert not correct(tiny_cell(name), 5, fault=fault)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_train_faults_are_not_correct(fault):
    assert not correct(tiny_cell("tracknet_base.train_b16"), 5, fault=fault)


@pytest.mark.parametrize("name, seed", [(SERVE[0], 1), (SERVE[0], 5)])
def test_serve_control_is_not_correct(name, seed):
    """The port's own int8 path in the place of the bf16 one (at this size
    TrackNet's seeds 2-4 read under the limit set at the cell's own size;
    PERF.md)."""
    assert not correct(tiny_cell(name), seed, control="int8")


@pytest.mark.parametrize("name", ["tracknet_base.train_b16", "tracknet_base.train_ddp4_b64"])
def test_train_control_is_not_correct(name):
    """The reference in float8 training in the program's place (at this size
    the one-card cell's seeds 1, 3 and 6 read under the limits set at its
    own size; PERF.md)."""
    cell = tiny_cell(name)
    numbers = Train.control_numbers(cell, 7, CPU, shards=cell.chips)
    numbers.pop("look")
    assert not judge(numbers, cell.limits)[0]


def _ddp(fault, tmp_path):
    from benchmark.tests.ddp_worker import rank

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=rank, args=(r, 2, port, outs[r], fault)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not any(alive) and all(p.exitcode == 0 for p in procs)
    return [json.load(open(o)) for o in outs]


@pytest.mark.parametrize("fault, ok", [(None, True), ("no_exchange", False)])
def test_data_parallel_cell_over_two_gloo_ranks(fault, ok, tmp_path):
    """Two ranks stop after the same step; the exchange between them left
    out is not correct."""
    res = _ddp(fault, tmp_path)
    assert res[0]["steps"] == res[1]["steps"]
    limits = tiny_cell("tracknet_base.train_ddp4_b64").limits
    assert judge(res[0]["numbers"], limits)[0] is ok


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = harness.main(["--workload", SERVE[0], "--seed", "1", "--seconds", "1"])
    assert code != 0 and buf.getvalue() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's folder,
    a run exits non-zero and prints nothing on standard output."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", SERVE[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", SERVE[0],
                          "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
