"""The readings a cell's limits are set from, on the chip, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--program] [--control] [--faults] [--seconds 2] [--out file.jsonl]

--program: the program's numbers on each seed: set-up and a short window
  at the cell's own load (serve), or the first steps (train), then the
  check, as a run makes them (the lower readings); a cell on one chip.
--control, --witness, --faults: what the cell's task names for them
  (`calibration(cell)` in benchmark/harness/tasks/<task>.py): each either
  a run of the program with the control or the fault planted in it, or
  the reference put in the program's place. TrackNet: the bf16 serve
  form's control is the port's int8 form, the int8 form's the int8 form
  with its activation scales times 4; training's, the reference in
  float8; the witness is the reference computed in bf16; the faults are
  "half_batch", "stale" and "altered" in serving and "half_batch" (and
  over several chips "no_exchange") in training.
One JSON line a reading; PERF.md gives the readings each limit was set
from. The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def plan(cell, parts: Sequence[str]) -> List[Tuple[str, Any]]:
    """The readings of `parts` ("program", "control", "witness",
    "faults"), in that order, as (kind, how): `how` is the options of a
    run of the program, or a function (seed, device) -> numbers."""
    from benchmark.harness import tasks

    steps: List[Tuple[str, Any]] = []
    if "program" in parts and cell.chips == 1:
        steps.append(("program", {}))
    named = tasks.calibration(cell)
    for part in ("control", "witness", "faults"):
        if part in parts:
            steps += named[part]
    return steps


def read(cell, seed: int, how: Any, device, seconds: float) -> Dict[str, Any]:
    """One reading: {"numbers": ...} and, of a run, its notes and seconds."""
    from benchmark.harness import guard
    from benchmark.harness.main import run_job

    if callable(how):
        guard.reference_numerics()
        return {"numbers": how(seed, device)}
    t = time.perf_counter()
    res = run_job(cell, seed, seconds, False, device, **how)
    return {"numbers": res["numbers"], "notes": res.get("notes"),
            "seconds": time.perf_counter() - t}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    parts = ("program", "control", "witness", "faults")
    for part in parts:
        p.add_argument(f"--{part}", action="store_true")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import torch

    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    steps = plan(cell, [part for part in parts if getattr(args, part)])
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind, how in steps:
            line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                               **read(cell, seed, how, device, args.seconds)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
