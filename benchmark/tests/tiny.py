"""The benchmark's cells cut to a size a CPU test run holds: width 0.25,
frames of 64x32, batches of 4, a 1280x720 original cut to 128x72, 3
sampled rows among 2 steps."""
import copy

from benchmark.harness.spec import Cell, load_cell


def tiny_cell(name: str, dtype: str = "float32") -> Cell:
    cell = copy.deepcopy(load_cell(name))
    mc = cell.config["model_config"]
    for part in ("encoder_config", "decoder_config"):
        mc["base_arch_config"][part]["width_multiple"] = 0.25
    cell.config["train_config"]["img_config"]["img_wh"] = [64, 32]
    mc["dtype"] = dtype
    t = cell.traffic
    for k in ("batch", "global_batch"):
        if k in t:
            t[k] = 4
    t.update(og_hw=[72, 128], sample_steps=2, sample_rows=3, calibration_rows=2)
    return cell
