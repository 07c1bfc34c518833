"""Time the ways to write TrackNet base's enc_0 input with the serve
form's zero channels (nn/channel_pad.py) on one NVIDIA GPU:

    python3 dev/bench_torch_channel_pad.py

The input is the 9-channel f32 frame stack (batch 32, 640x352, NHWC as
copied from the host). The bf16 form casts it to 16 bf16 channels
(`channel_pad.widen` against a slice fill, F.pad and a concatenation);
the int8 form quantizes the 9-channel bf16 map into 16 int8 channels
(`ops.int8.quantize_activation` with a channel count, against a slice
fill and the quantize pass of the widened map). Each is held equal to
F.pad of the 9-channel result and timed with CUDA events
(chip_smoke.device_ms) beside the unpadded cast and quantize pass. The
padded convs themselves are timed against their unpadded and narrow-path
launches by `dev/bench_torch_kernel_variants.py --narrow chosen narrow`.
Prints one line per way and writes chiprun_out/channel_pad_bench.json.
Needs the GPU; a development tool, not part of the port.
"""
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from vision_conglomerate_torch.nn import channel_pad  # noqa: E402
from vision_conglomerate_torch.ops import int8  # noqa: E402


def producer_options(g):
    """Ways to write enc_0's input, the 9-channel f32 frame stack (B 32,
    640x352, NHWC as copied from the host), as 16 bf16 channels, and the
    int8 quantize pass of the 9-channel bf16 map into 16 channels; each
    held equal to F.pad of the 9-channel result."""
    b, h, w = 32, 352, 640
    x = torch.rand(b, h, w, 9, device="cuda", generator=g)
    xb = x.to(torch.bfloat16)
    z7 = torch.zeros(1, 1, 1, 7, device="cuda", dtype=torch.bfloat16)
    x_s = torch.tensor(1.0 / 64, device="cuda")

    def slice_fill():
        out = torch.empty(b, h, w, 16, device="cuda", dtype=torch.bfloat16)
        out[..., 9:].zero_()
        out[..., :9].copy_(x)
        return out

    def quantize_slice_fill():
        q = torch.clamp(torch.round(xb.float() / x_s), -127, 127)
        out = torch.empty(b, h, w, 16, device="cuda", dtype=torch.int8)
        out[..., 9:].zero_()
        out[..., :9].copy_(q)
        return out

    options = {
        "cast to bf16, 9 channels (no pad)": (lambda: x.to(torch.bfloat16), None),
        "widen: zero fill, then copy (the port)": (
            lambda: channel_pad.widen(x.permute(0, 3, 1, 2), 16, torch.bfloat16).permute(
                0, 2, 3, 1), F.pad(xb, (0, 7))),
        "empty, zero the pad slice, copy": (slice_fill, F.pad(xb, (0, 7))),
        "cast, then F.pad": (lambda: F.pad(x.to(torch.bfloat16), (0, 7)), F.pad(xb, (0, 7))),
        "cast, then cat with zeros": (lambda: torch.cat(
            (x.to(torch.bfloat16), z7.expand(b, h, w, 7)), -1), F.pad(xb, (0, 7))),
        "quantize pass, 9 channels (no pad)": (lambda: int8.quantize_activation(xb, x_s), None),
        "quantize pass into 16 (the port)": (
            lambda: int8.quantize_activation(xb, x_s, 16),
            F.pad(int8.quantize_activation(xb, x_s), (0, 7))),
        "quantize pass, empty, zero the pad slice, copy": (
            quantize_slice_fill, F.pad(int8.quantize_activation(xb, x_s), (0, 7))),
        "quantize pass of the widened 16-channel map": (
            lambda: int8.quantize_activation(F.pad(xb, (0, 7)), x_s),
            F.pad(int8.quantize_activation(xb, x_s), (0, 7))),
    }
    rows = []
    for name, (fn, want) in options.items():
        ok = want is None or torch.equal(fn(), want)
        ms = chip_smoke.device_ms(fn)
        rows.append(dict(producer=name, ms=ms, ok=ok))
        print(f"enc_0 input {name}: {ms:.4f} ms{'' if ok else ' MISMATCH'}", flush=True)
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this tool runs on the GPU only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    rows = producer_options(torch.Generator(device="cuda").manual_seed(chip_smoke.SEED))
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "channel_pad_bench.json"), "w") as f:
        json.dump(dict(card=card, producers=rows), f, indent=1)
    bad = [r["producer"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"ways disagree with F.pad of the unpadded result: {bad}")


if __name__ == "__main__":
    main()
