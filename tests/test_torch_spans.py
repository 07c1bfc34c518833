"""The port's spans (`utils.profiling.span`) on the CPU: off, one shared
no-op context that records nothing; on (`collect(True)`, `trace()` or a
running torch.profiler), records that carry their parent and one step id
per root span, the span trees of a TrackNet serve batch and train step in
call order (remat included), results bit for bit those of a run with the
spans off, the `vct.*` ranges nested in the CPU profiler's events, and one
`train.sync` a step on each of two gloo ranks. `train_tracknet
--profile_dir` writes a trace with the spans in it.

This module imports no JAX: the ranks import it to run `sync_rank`.
"""
import copy
import json
import os
import threading

import numpy as np
import pytest
import torch

from vision_conglomerate_torch.utils import profiling
from vision_conglomerate_torch.utils.profiling import collect, span, span_ms, span_records

CONFIG = {"architecture": "base", "base_arch_config": {
    "encoder_config": {"width_multiple": 0.25}, "decoder_config": {"width_multiple": 0.25}}}
H, W = 32, 64
SERVE_TREE = [("serve.batch", None), ("tracknet.encoder", "serve.batch"),
              ("tracknet.decoder", "serve.batch"), ("tracknet.heatmap", "serve.batch"),
              ("serve.decode", "serve.batch")]
TRAIN_TREE = [("train.step", None), ("train.forward", "train.step"),
              ("tracknet.encoder", "train.forward"), ("tracknet.decoder", "train.forward"),
              ("train.loss", "train.step"), ("train.backward", "train.step"),
              ("train.optimizer", "train.step")]


@pytest.fixture(autouse=True)
def spans_off():
    """Each test starts and ends with the spans off and no records."""
    collect(True)
    collect(False)
    yield
    collect(True)
    collect(False)


def tiny_tracknet(config=CONFIG, seed: int = 0):
    from vision_conglomerate_torch.models import TrackNet

    torch.manual_seed(seed)
    return TrackNet(config)


def frames(n: int = 2, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=(n, H, W, 9)).astype(np.float32)


def train_batch(n: int = 2, seed: int = 2):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, size=(n, H, W, 9), dtype=np.uint8))
    hm = torch.from_numpy(rng.integers(0, 256, size=(n, H, W)).astype(np.uint8))
    return x, hm


def pipeline(config=CONFIG):
    from vision_conglomerate_torch.train.optim import make_optimizer
    from vision_conglomerate_torch.train.tracknet_trainer import TrainTrackNetPipeline

    net = tiny_tracknet(config).train()
    optimizer, _ = make_optimizer({"name": "Adadelta", "lr": 1.0, "rho": 0.9, "eps": 1e-6,
                                   "weight_decay": 0}, net)
    return TrainTrackNetPipeline(net, optimizer, init_scheme=None)


def tree(records):
    return [(r["name"], r["parent"]) for r in records]


def test_off_span_is_one_shared_noop_that_records_nothing():
    from vision_conglomerate_torch.infer.tracknet_runner import track_batch

    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = span("serve.batch"), span("train.step")
    assert a is b is profiling._NULL
    with a as got:
        assert got is None
    track_batch(tiny_tracknet().eval(), frames(), (H, W))
    pipeline().train_step(*train_batch())
    assert span_records() == [] and span_ms() == {}


def test_nested_spans_carry_their_parent_and_one_step_id():
    collect(True)
    with span("a"):
        with span("b"):
            with span("c"):
                pass
        with span("d"):
            pass
    with span("a"):
        with span("b"):
            pass
    got = [(r["name"], r["parent"], r["step"]) for r in span_records()]
    assert got == [("a", None, 1), ("b", "a", 1), ("c", "b", 1), ("d", "a", 1),
                   ("a", None, 2), ("b", "a", 2)]
    recs = span_records()
    assert all(r["device_ms"] is None and r["host_ms"] >= 0 for r in recs)
    assert recs[0]["host_start_ns"] <= recs[1]["host_start_ns"] <= recs[1]["host_end_ns"] \
        <= recs[0]["host_end_ns"]
    assert sorted(span_ms()) == ["a", "b", "c", "d"] and len(span_ms()["a"]) == 2


def test_a_span_on_another_thread_starts_no_step_of_its_own():
    """A root span opened on another thread joins the step open on the
    main thread (its parent is None: the stack is the thread's own); with
    no step open it starts one."""
    collect(True)

    def other():
        with span("worker"):
            pass

    with span("root"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    got = [(r["name"], r["parent"], r["step"]) for r in span_records()]
    assert got == [("root", None, 1), ("worker", None, 1), ("worker", None, 2)]


def test_collect_starts_afresh():
    collect(True)
    with span("a"):
        pass
    collect(False)
    assert [r["name"] for r in span_records()] == ["a"]  # kept until read
    collect(True)
    assert span_records() == []
    with span("b"):
        pass
    assert [(r["name"], r["step"]) for r in span_records()] == [("b", 1)]


def test_track_batch_records_its_tree_and_the_same_tracks():
    from vision_conglomerate_torch.infer.tracknet_runner import track_batch

    net, x = tiny_tracknet().eval(), frames(3)
    off = track_batch(net, x, (2 * H, 2 * W), threshold=1)
    collect(True)
    on = [track_batch(net, x, (2 * H, 2 * W), threshold=1) for _ in range(2)]
    collect(False)
    for t in on:
        np.testing.assert_array_equal(t, off)
    recs = span_records()
    assert tree(recs) == SERVE_TREE * 2
    assert [r["step"] for r in recs] == [1] * 5 + [2] * 5


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_records_its_tree_and_the_same_step(remat):
    """Remat recomputes each conv in the backward, not TrackNet.forward: its
    spans are not opened again there, and every span of a step keeps the
    step's id."""
    config = copy.deepcopy(CONFIG)
    config["remat"] = remat
    off, on = pipeline(config), pipeline(config)
    assert all(torch.equal(p, q) for p, q in zip(off.model.parameters(), on.model.parameters()))
    batches = [train_batch(seed=s) for s in (3, 4)]
    losses_off = [off.train_step(*b) for b in batches]
    collect(True)
    losses_on = [on.train_step(*b) for b in batches]
    collect(False)
    for a, b in zip(losses_off, losses_on):
        assert torch.equal(a, b)
    for (n, p), q in zip(off.model.named_parameters(), on.model.parameters()):
        assert torch.equal(p, q), n
    for a, b in zip(off.model.buffers(), on.model.buffers()):
        assert torch.equal(a, b)
    recs = span_records()
    assert tree(recs) == TRAIN_TREE * 2
    assert [r["step"] for r in recs] == [1] * 7 + [2] * 7


def test_vct_ranges_nest_in_the_cpu_profilers_events():
    """A running torch.profiler turns the spans on by itself: its events hold
    `vct.<name>` ranges, each inside its parent's, and the records hold the
    spans."""
    from torch.profiler import ProfilerActivity, profile

    from vision_conglomerate_torch.infer.tracknet_runner import track_batch

    net, x = tiny_tracknet().eval(), frames()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        track_batch(net, x, (H, W))
    events = [e for e in prof.events() if e.name.startswith("vct.")]
    assert [e.name for e in events] == ["vct." + n for n, _ in SERVE_TREE]
    by_name = {e.name: e for e in events}
    for name, parent in SERVE_TREE[1:]:
        e, p = by_name["vct." + name], by_name["vct." + parent]
        assert e.cpu_parent is not None and e.cpu_parent.name == p.name
        assert p.time_range.start <= e.time_range.start <= e.time_range.end <= p.time_range.end
    assert tree(span_records()) == SERVE_TREE
    # off again once the profiler has stopped
    assert span("serve.batch") is profiling._NULL


def test_train_tracknet_profile_dir_traces_the_spans(tmp_path):
    from vision_conglomerate_torch.train_tracknet import build_parser
    from vision_conglomerate_torch.utils.profiling import trace

    assert build_parser().parse_args([]).profile_dir == ""
    args = build_parser().parse_args(["--profile_dir", str(tmp_path / "prof")])
    assert args.profile_dir == str(tmp_path / "prof")
    pipe = pipeline()
    with trace(args.profile_dir):
        pipe.train_step(*train_batch())
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"vct." + n for n, _ in TRAIN_TREE} <= names
    assert (tmp_path / "prof" / "ops.txt").is_file()
    # the records are not kept, and the spans are off again
    assert span_records() == [] and span("train.step") is profiling._NULL


def sync_rank(out_dir: str) -> None:
    """One gloo rank: two train steps of a tiny TrackNet with the spans on;
    writes its records to rank<r>.json."""
    from vision_conglomerate_torch.parallel import mesh
    from vision_conglomerate_torch.parallel.mesh import shard_batch

    torch.set_num_threads(1)
    mesh.maybe_initialize_distributed("cpu")
    pipe = pipeline()
    collect(True)
    for s in (5, 6):
        pipe.train_step(*shard_batch(train_batch(4, seed=s)))
    collect(False)
    with open(os.path.join(out_dir, f"rank{mesh.rank()}.json"), "w") as f:
        json.dump(span_records(), f)
    mesh.shutdown_distributed()


def test_two_gloo_ranks_each_record_one_sync_a_step(tmp_path):
    from test_torch_ddp import N_RANKS, finish_ranks, start_ranks

    finish_ranks(start_ranks(f"import test_torch_spans as t; t.sync_rank({str(tmp_path)!r})"))
    sync_tree = TRAIN_TREE[:-1] + [("train.sync", "train.step"), TRAIN_TREE[-1]]
    for r in range(N_RANKS):
        with open(tmp_path / f"rank{r}.json") as f:
            recs = json.load(f)
        assert tree(recs) == sync_tree * 2
        syncs = [x["step"] for x in recs if x["name"] == "train.sync"]
        assert syncs == [1, 2]
