"""What a per-layer metric's reader (benchmark/metrics/<name>.py) gets.

`read(ctx)` returns the metric's value, or None where it finds nothing to
read, and the harness leaves a None out of the result line.
"""
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import peaks
from .spec import Cell, load_module
from .trace import TraceSummary


@dataclass
class LayerContext:
    cell: Cell
    mode: str                      # the traffic's mode: "serve" or "train"
    steps: int                     # steps (batches) in the traced window
    trace: TraceSummary            # device ops, busy time, ops' own device time
    spans: Dict[str, List[float]]  # the benchmark's CUDA-event spans, ms per step
    records: List[tuple]           # conv records of one step's forward (reference)
    peaks: Any = field(default=peaks)

    def counts(self, name: str):
        """benchmark/counts/<name>.py."""
        return load_module("counts", name, self.cell.root)


def read_metrics(cell: Cell, ctx: LayerContext) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for m in cell.per_layer:
        value: Optional[float] = load_module("metrics", m["name"], cell.root).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
