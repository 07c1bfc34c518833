"""One run of one cell: set-up, the measured window, the check.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as `setup_s`) builds the program's model from the seed's
weights, makes the cell's inputs on the device and warms every shape the
window uses (a training cell takes its first steps, which the reference
follows). The window then runs the timed path for `--seconds` (with
`--trace 1` for at most TRACE_SECONDS, under torch.profiler, to read the
per-layer metrics). After it: the peak memory is read, the program's
state freed, and the plain reference judges what the window produced
(harness/compare.py). The last line of standard output is one JSON
object; the numbers compared, each beside its limit, end standard error
and the line.

A cell on several chips starts one process a chip (ranks of the port's
process group on localhost); each writes its result into the run's
TMPDIR and rank 0's is printed, with the peak of the fullest chip and the
busy time averaged over the chips.
"""
import argparse
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

from . import guard
from .spec import ROOT, Cell, load_cell

TRACE_SECONDS = 3.0
# what a job reports beside its numbers (standard error, `note` lines)
NOTES = ("track_gap_px", "look", "setup_parts")
RUN_LIMIT_S = 330.0


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank-out", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def quantile95(values: List[float]) -> float:
    if len(values) < 2:
        return values[0] if values else math.nan
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def run_job(cell: Cell, seed: int, seconds: float, trace: bool, device,
            control: Optional[str] = None, fault: Optional[str] = None,
            check: bool = True, before_check=None, witness: bool = False) -> Dict[str, Any]:
    """Set-up, window and check of one process; returns its result
    (without the cross-rank merge). `before_check` runs once the program's
    state is freed (a rank leaves its process group there). `witness`: the
    reference in bf16 is judged in the program's place (benchmark/calibrate.py)."""
    import torch

    from . import tasks
    from .layer_context import LayerContext, read_metrics
    from .trace import breakdown, summarize

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    job = tasks.make_job(cell, seed, device, control=control, fault=fault)
    mode = cell.traffic["mode"]
    sync()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    length = min(seconds, TRACE_SECONDS) if trace else seconds
    agree = tasks.stop_agreement(device)
    first = getattr(job, "first_window_step", 0)
    # the window lasts `seconds`, and at least as many steps as the check
    # samples from (a few batches; far fewer than a window at the cell's size)
    min_steps = getattr(job, "min_steps", 1)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        job.spans(True)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        prof.__enter__()
    latencies: List[float] = []
    steps = 0
    start = time.perf_counter()
    deadline = start + length
    while True:
        t = time.perf_counter()
        job.step(first + steps)
        steps += 1
        if mode == "serve":
            latencies.append(time.perf_counter() - t)
            if time.perf_counter() >= deadline and steps >= min_steps:
                break
        elif agree(time.perf_counter() >= deadline and steps >= min_steps):
            break
    sync()
    window_s = time.perf_counter() - start
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    result: Dict[str, Any] = {"attempted": steps, "failed": 0, "setup_s": setup_s,
                              "window_s": window_s, "steps": steps, "peak_bytes": peak,
                              "items": steps * job.items_per_step}
    if mode == "serve":
        result["latencies_ms"] = [v * 1e3 for v in latencies]
    if prof is not None:
        summary = summarize(prof, window_s)
        ctx = LayerContext(cell=cell, mode=mode, steps=steps, trace=summary,
                           spans=job.span_ms(), records=job.records)
        result["per_layer"] = read_metrics(cell, ctx)
        result["busy_s"] = summary.busy_s
        result["breakdown"] = breakdown(summary)
        job.spans(False)
        del prof
    job.release()
    if cuda:
        torch.cuda.empty_cache()
    if before_check is not None:
        before_check()
    guard.reference_numerics()
    result["numbers"] = (job.check(witness=True) if witness else job.check()) if check else {}
    result["notes"] = {k: getattr(job, k) for k in NOTES if hasattr(job, k)}
    return result


def end_to_end(cell: Cell, res: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    values = {
        "setup_s": (res["setup_s"], "s"),
        "serve_img_per_s": (res["items"] / res["window_s"], "img/s"),
        "train_img_per_s": (res["items"] / res["window_s"], "img/s"),
        "ddp_train_img_per_s": (res["items"] / res["window_s"], "img/s"),
        "serve_batch_p95_ms": (quantile95(res.get("latencies_ms", [])), "ms"),
        "peak_mem_gib": (res["peak_bytes"] / 2 ** 30, "GiB"),
    }
    return {m["name"]: {"value": values[m["name"]][0], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(args: argparse.Namespace, cell: Cell) -> List[Dict[str, Any]]:
    """Start one process a chip and collect their results."""
    out_dir = tempfile.mkdtemp(prefix="bench-ranks-")
    port = _free_port()
    procs = []
    for r in range(cell.chips):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(cell.chips),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--rank", str(r), "--rank-out", os.path.join(out_dir, f"rank{r}.json")]
        procs.append(subprocess.Popen(cmd, env=env, stdout=sys.stderr))
    end = time.monotonic() + RUN_LIMIT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > end or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise SystemExit(f"rank processes ended with codes {codes}")
    results = []
    for r in range(cell.chips):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
        os.remove(os.path.join(out_dir, f"rank{r}.json"))
    os.rmdir(out_dir)
    return results


def rank_main(args: argparse.Namespace, cell: Cell) -> int:
    """One rank of a multi-chip cell: join the group, run, write the result."""
    import torch

    from vision_conglomerate_torch.parallel.mesh import maybe_initialize_distributed

    from vision_conglomerate_torch.parallel.mesh import shutdown_distributed

    device = maybe_initialize_distributed("cuda", seed=args.seed)
    res = run_job(cell, args.seed, args.seconds, bool(args.trace), device,
                  check=args.rank == 0, before_check=shutdown_distributed)
    res["forbidden"] = guard.forbidden_modules()
    res["device_name"] = torch.cuda.get_device_name(device)
    with open(args.rank_out, "w") as f:
        json.dump(res, f)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    if args.rank is not None:
        return rank_main(args, cell)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        ranks = run_ranks(args, cell)
        res = dict(ranks[0])
        res["peak_bytes"] = max(r["peak_bytes"] for r in ranks)
        res["items"] = sum(r["items"] for r in ranks)
        if args.trace:
            res["busy_s"] = statistics.fmean(r["busy_s"] for r in ranks)
        forbidden = sorted({m for r in ranks for m in r["forbidden"]})
        name = ranks[0]["device_name"]
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        res = run_job(cell, args.seed, args.seconds, bool(args.trace), device)
        forbidden = []
        name = torch.cuda.get_device_name(device)
    forbidden = sorted(set(forbidden) | set(guard.forbidden_modules()))
    if forbidden:
        print(f"benchmark: modules of JAX or the JAX package were imported: {forbidden}",
              file=sys.stderr)
        return 3
    return report(cell, res, bool(args.trace), name)


def report(cell: Cell, res: Dict[str, Any], trace: bool, device_name: str) -> int:
    from .compare import judge

    correct, checks = judge(res["numbers"], cell.limits)
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": int(res["peak_bytes"])}
    line: Dict[str, Any] = {"correct": correct, "attempted": res["attempted"],
                            "failed": res["failed"]}
    if trace:
        line["metrics"] = res["per_layer"]
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    else:
        line["metrics"] = end_to_end(cell, res)
    line["device"] = device
    if trace:
        line["breakdown"] = res["breakdown"]
    for k, v in res.get("notes", {}).items():
        print(f"note {k} {v!r}", file=sys.stderr)
    for k, v in res["numbers"].items():
        if k not in checks:
            print(f"note {k} {v!r} (not compared in this cell)", file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} <= {lim!r}: {'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    line["checks"] = {k: {"value": _num(v), "limit": _num(lim)} for k, (v, lim) in checks.items()}
    print(json.dumps(line))
    return 0


def _num(v: float) -> Optional[float]:
    return v if math.isfinite(v) else None
