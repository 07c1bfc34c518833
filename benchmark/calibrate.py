"""The readings a cell's limits are set from, on the chip, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--program] [--control] [--faults] [--seconds 2] [--out file.jsonl]

--program: the program's numbers on each seed: set-up and a short window
  at the cell's own load (serve), or the first steps (train), then the
  check, as a run makes them (the lower readings).
--control: the control on each seed: serving, the port's own int8 path;
  training, the reference in float8 in the program's place.
--witness: the reference computed in bf16 in the program's place: what
  bf16 alone reads on the same sample (serving) or the same first steps
  (training; the convs under bf16 autocast), a second witness.
--faults: each fault the timed path can have, planted on each seed:
  serving in the program ("half_batch", "stale", "altered"); training in
  the reference put in the program's place ("half_batch", and over
  several chips "no_exchange"); a state left unchanged reads 1 and needs
  no run.
One JSON line a reading; PERF.md gives the readings each limit was set
from. The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--witness", action="store_true")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import torch

    from benchmark.harness.main import run_job
    from benchmark.harness.spec import load_cell
    from benchmark.harness.tasks.tracknet import Train
    from benchmark.harness import guard

    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    seeds = [int(s) for s in args.seeds.split(",")]
    mode = cell.traffic["mode"]
    shards = cell.chips
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, **extra):
        line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                           "numbers": numbers, **extra})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def serve(kind, seed, **opts):
        t = time.perf_counter()
        res = run_job(cell, seed, args.seconds, False, device, **opts)
        emit(kind, seed, res["numbers"], notes=res.get("notes"),
             seconds=time.perf_counter() - t)

    for seed in seeds:
        if args.program:
            if mode == "serve" or shards == 1:
                serve("program", seed)
        if args.control:
            if mode == "serve":
                serve("control_int8", seed, control="int8")
            else:
                guard.reference_numerics()
                emit("control_fp8", seed, Train.control_numbers(cell, seed, device,
                                                                shards=shards))
        if args.witness:
            if mode == "serve":
                serve("witness_bf16_reference", seed, witness=True)
            else:
                guard.reference_numerics()
                emit("witness_bf16_reference", seed, Train.control_numbers(
                    cell, seed, device, shards=shards, bf16=True))
        if args.faults:
            if mode == "serve":
                for fault in ("half_batch", "stale", "altered"):
                    serve(f"fault_{fault}", seed, fault=fault)
            else:
                guard.reference_numerics()
                faults = ("half_batch", "no_exchange") if shards > 1 else ("half_batch",)
                for fault in faults:
                    emit(f"fault_{fault}", seed, Train.control_numbers(
                        cell, seed, device, fault=fault, shards=shards))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
