"""Time the PyTorch port's detection train step with and without the
data-parallel sync (`BasePipeline._sync_train_step`: the flat all-reduce of
gradients and BatchNorm statistics, and of the metrics) on one card, in a
world of one (NCCL).

chip_smoke.py's seeded detector at the shipped config, bf16, one batch of
16 of its synthetic 640x640 images; 20 blocks of 10 synchronized steps
(host clock) in turns: plain, DDP, DDP, plain, ... The process group stays
up; a plain block hides it from the trainer. Prints each block's ms a step,
the medians and the card.

    python3 dev/torch_ddp_step.py
"""
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vision_conglomerate_torch.parallel import mesh  # noqa: E402
from vision_conglomerate_torch.train import base  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script times the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as root:
        config, _, _ = cs.write_train_data(root, cs.TRAIN_BATCH)
        net = cs.seeded_net(config, cs.shipped_anchors("detection"), torch.bfloat16, "cuda")
        pipe = cs.trainer(net, config)
        batch = [torch.from_numpy(a).cuda() for a in cs.train_batch(config, cs.TRAIN_BATCH)]
        mesh.maybe_initialize_distributed("cuda")
        distributed = base.is_distributed
        times = {"plain": [], "ddp": []}
        try:
            for mode in ["plain", "ddp", "ddp", "plain"] * 5:
                base.is_distributed = distributed if mode == "ddp" else (lambda: False)
                times[mode].append(cs.timed_steps(pipe, batch))
        finally:
            base.is_distributed = distributed
            mesh.shutdown_distributed()
    for mode, ms in times.items():
        print(f"{mode}: ms a step per block {[round(t, 3) for t in ms]}, median "
              f"{statistics.median(ms):.3f}")
    print(f"ddp - plain: {statistics.median(times['ddp']) - statistics.median(times['plain']):.3f}"
          f" ms a step (medians); batch {cs.TRAIN_BATCH}, 640x640, bf16; card: {card}")


if __name__ == "__main__":
    main()
