"""One gloo rank of the data-parallel training cell at the tiny size (the
CPU tests start two)."""
import json
import os


def rank(r: int, world: int, port: int, out: str, fault) -> None:
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch

    from benchmark.harness.main import run_job
    from benchmark.tests.tiny import tiny_cell
    from vision_conglomerate_torch.parallel.mesh import (maybe_initialize_distributed,
                                                         shutdown_distributed)

    torch.set_num_threads(2)
    device = maybe_initialize_distributed("cpu", seed=11)
    cell = tiny_cell("tracknet_base.train_ddp4_b64")
    res = run_job(cell, 11, 0.01, False, device, fault=fault, check=r == 0,
                  before_check=shutdown_distributed)
    with open(out, "w") as f:
        json.dump({"numbers": res["numbers"], "steps": res["steps"]}, f)
