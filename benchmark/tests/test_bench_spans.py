"""The metrics that read the program's own spans (harness/program_spans.py),
on synthetic contexts and at the tiny size on the CPU: the span means, the
device idle inside a root span, the wait for the slowest rank; nothing read
(and nothing raised) where the program has no spans, as an older parent
has not; every metric that was there before reads the same with the
program's spans beside it; a traced run of two gloo ranks gathers every
rank's records and ends."""
import json
import multiprocessing
import socket
from types import SimpleNamespace

import pytest

from benchmark.harness import program_spans
from benchmark.harness.layer_context import LayerContext, read_metrics
from benchmark.harness.spec import load_cell, load_module
from benchmark.harness.trace import TraceSummary

SERVE, TRAIN, DDP = ("tracknet_base.serve_b32", "tracknet_base.train_b16",
                     "tracknet_base.train_ddp4_b64")
FLAG = "ncclDevKernel_AllReduce_Max_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
NEW = {SERVE: ["span.serve.encoder_ms", "span.serve.decoder_ms", "span.serve.heatmap_ms",
               "span.serve.decode_ms", "span.serve.idle_ms"],
       TRAIN: ["span.train.forward_ms", "span.train.loss_ms", "span.train.backward_ms",
               "span.train.optimizer_ms", "span.train.idle_ms"],
       DDP: ["span.ddp.backward_ms", "span.ddp.sync_ms", "span.ddp.optimizer_ms",
             "span.ddp.idle_ms", "ddp.rank_wait_ms"]}


def rec(name, parent, step, ms):
    return {"name": name, "parent": parent, "step": step, "host_ms": ms, "device_ms": ms}


def serve_records(steps=2):
    out = []
    for s in range(1, steps + 1):
        out += [rec("serve.batch", None, s, 10.0 + s), rec("tracknet.encoder", "serve.batch", s, 3.0 * s),
                rec("tracknet.decoder", "serve.batch", s, 5.0),
                rec("tracknet.heatmap", "serve.batch", s, 1.0),
                rec("serve.decode", "serve.batch", s, 0.5 + s)]
    return out


def train_records(syncs, step_ms=10.0):
    out = []
    for s, sync in enumerate(syncs, 1):
        out += [rec("train.step", None, s, step_ms), rec("train.forward", "train.step", s, 2.0),
                rec("tracknet.encoder", "train.forward", s, 1.0),
                rec("tracknet.decoder", "train.forward", s, 1.0),
                rec("train.loss", "train.step", s, 1.0), rec("train.backward", "train.step", s, 4.0),
                rec("train.sync", "train.step", s, sync),
                rec("train.optimizer", "train.step", s, 0.5)]
    return out


def context(name, steps, recs=None, ops=(), ranks=None, spans=None):
    cell = load_cell(name)
    trace = TraceSummary(1.0, 0.5, list(ops), {"aten::cudnn_convolution": 0.4})
    ctx = LayerContext(cell=cell, mode=cell.traffic["mode"], steps=steps, trace=trace,
                       spans=spans or {}, records=[("conv", 4, 8, 8, 16, 16, 3, 1, "conv3x3")])
    if recs is not None:
        ctx.program_spans = recs
    if ranks is not None:
        ctx.rank_program_spans = ranks
    return cell, ctx


def test_the_span_means_read_their_span_in_their_root():
    _, ctx = context(SERVE, 2, serve_records())
    got = {n: load_module("metrics", n).read(ctx) for n in NEW[SERVE][:4]}
    assert got == {"span.serve.encoder_ms": 4.5, "span.serve.decoder_ms": 5.0,
                   "span.serve.heatmap_ms": 1.0, "span.serve.decode_ms": 2.0}
    _, ctx = context(TRAIN, 3, train_records([1.0, 2.0, 3.0]))
    got = {n: load_module("metrics", n).read(ctx) for n in NEW[TRAIN][:4]}
    assert got == {"span.train.forward_ms": 2.0, "span.train.loss_ms": 1.0,
                   "span.train.backward_ms": 4.0, "span.train.optimizer_ms": 0.5}
    _, ctx = context(DDP, 3, train_records([1.0, 2.0, 3.0]))
    assert load_module("metrics", "span.ddp.sync_ms").read(ctx) == 2.0
    # a serve span in a train step is not a serve batch's
    assert program_spans.mean_ms(ctx, "tracknet.encoder", "serve.batch") is None


def test_records_that_do_not_cover_the_windows_steps_read_nothing():
    _, ctx = context(SERVE, 3, serve_records(2))
    assert all(load_module("metrics", n).read(ctx) is None for n in NEW[SERVE])
    host_only = [dict(r, device_ms=None) for r in serve_records()]
    _, ctx = context(SERVE, 2, host_only, ops=[("k", 0.0, 1e-3)])
    assert all(load_module("metrics", n).read(ctx) is None for n in NEW[SERVE])


def test_idle_inside_the_root_spans_is_their_time_less_the_busy_union():
    """Two batches of 11 and 12 ms; device operations whose union is 15 ms
    (two overlap): 8 ms of idle in 2 batches. In the data-parallel cell the
    stop flag's all-reduce between steps (3 ms) is left out."""
    ops = [("k1", 0.000, 0.006), ("k2", 0.004, 0.004), ("k3", 0.012, 0.007)]
    _, ctx = context(SERVE, 2, serve_records(), ops)
    assert load_module("metrics", "span.serve.idle_ms").read(ctx) == pytest.approx(4.0)
    flag = [(FLAG, 0.020, 0.003), ("nccl:all_reduce", 0.020, 0.003)]
    _, ctx = context(DDP, 2, train_records([1.0, 1.0], step_ms=11.5), ops + flag)
    assert load_module("metrics", "span.ddp.idle_ms").read(ctx) == pytest.approx(4.0)
    _, ctx = context(TRAIN, 2, train_records([1.0, 1.0], step_ms=11.5), ops)
    assert load_module("metrics", "span.train.idle_ms").read(ctx) == pytest.approx(4.0)
    _, ctx = context(TRAIN, 2, train_records([1.0, 1.0]), [])
    assert load_module("metrics", "span.train.idle_ms").read(ctx) is None


def test_the_rank_wait_is_the_mean_sync_less_the_least():
    """Step 1: the ranks' syncs read 5, 3 and 1 ms (the last to arrive
    waited about nothing): 3 - 1 = 2 ms; step 2: 2, 2, 2: none. Mean 1."""
    ranks = [train_records([5.0, 2.0]), train_records([3.0, 2.0]), train_records([1.0, 2.0])]
    _, ctx = context(DDP, 2, ranks=ranks)
    reader = load_module("metrics", "ddp.rank_wait_ms")
    assert reader.read(ctx) == pytest.approx(1.0)
    _, ctx = context(DDP, 2, ranks=ranks[:1])
    assert reader.read(ctx) is None
    _, ctx = context(DDP, 2, ranks=[ranks[0], train_records([1.0])])
    assert reader.read(ctx) is None
    _, ctx = context(DDP, 2)  # one process, no process group
    assert reader.read(ctx) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The parent of the change that added the spans: its profiling module
    has no `span_records`; every new metric leaves itself out."""
    from vision_conglomerate_torch.utils import profiling

    monkeypatch.delattr(profiling, "span_records")
    for name, metrics in NEW.items():
        cell, ctx = context(name, 2, ops=[("k", 0.0, 1e-3)])
        out = read_metrics(cell, ctx)
        assert not set(metrics) & set(out)


@pytest.mark.parametrize("name", [SERVE, TRAIN, DDP])
def test_the_metrics_there_before_read_the_same_beside_the_programs_spans(name):
    """Each metric of the benchmark before the program's spans, read from a
    context without them and with them (as fields of the context, and as
    the program's own records)."""
    from vision_conglomerate_torch.utils import profiling

    cell, bare = context(name, 2, ops=[("bias_act_kernel<__nv_bfloat16, 9, x>", 0.0, 1e-3),
                                       ("k", 0.001, 2e-3)],
                         spans={"forward": [3.0], "tail": [1.0], "optimizer": [0.5]})
    recs = serve_records() if name == SERVE else train_records([1.0, 2.0])
    old = [m for m in cell.per_layer if m["name"] not in NEW[name]]
    assert old
    before = {m["name"]: load_module("metrics", m["name"]).read(bare) for m in old}
    _, ctx = context(name, 2, recs, ops=bare.trace.device_ops, ranks=[recs, recs],
                     spans=bare.spans)
    profiling.collect(True)
    with profiling.span("train.step"):
        pass
    profiling.collect(False)
    try:
        after = {m["name"]: load_module("metrics", m["name"]).read(ctx) for m in old}
        again = {m["name"]: load_module("metrics", m["name"]).read(bare) for m in old}
    finally:
        profiling.collect(True)
        profiling.collect(False)
    assert after == before and again == before
    assert any(v is not None for v in before.values())


def _traced_rank(r: int, port: int, out: str) -> None:
    import os

    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch

    from benchmark.harness.main import run_job
    from benchmark.tests.tiny import tiny_cell
    from vision_conglomerate_torch.parallel.mesh import (maybe_initialize_distributed,
                                                         shutdown_distributed)
    from vision_conglomerate_torch.utils.profiling import span_records

    torch.set_num_threads(2)
    device = maybe_initialize_distributed("cpu", seed=3)
    seen = {}

    def gather_then_leave():
        steps = len({x["step"] for x in span_records()})
        seen["ranks"] = program_spans.rank_records(SimpleNamespace(steps=steps))
        shutdown_distributed()

    res = run_job(tiny_cell(DDP), 3, 0.01, True, device, check=False,
                  before_check=gather_then_leave)
    with open(out, "w") as f:
        json.dump({"steps": res["steps"], "per_layer": sorted(res["per_layer"]),
                   "ranks": seen["ranks"]}, f)


def test_a_traced_run_of_two_ranks_gathers_every_ranks_spans(tmp_path):
    """The readers run on every rank in one order, so the rank-wait reader's
    gather meets on each; on the CPU the spans have no device time and no
    span metric is reported."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=_traced_rank, args=(r, port, outs[r])) for r in range(2)]
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
    for out in outs:
        got = json.load(open(out))
        assert not set(NEW[DDP]) & set(got["per_layer"])
        assert len(got["ranks"]) == 2
        for recs in got["ranks"]:
            syncs = [x["step"] for x in recs if x["name"] == "train.sync"]
            assert len(syncs) == got["steps"] == len(set(syncs))
