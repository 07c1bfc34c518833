#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its CUDA kernels
against their plain PyTorch versions.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # also writes a torch.profiler table

Phases (any failure exits non-zero; nothing is caught):
1. build: nvcc compiles every csrc/*.cu of the serve path for sm_90a, one
   process per source, all started together.
2. serve: a DetectionNet at the shipped config (configs/detection, width 0.5,
   depth 0.3, 640x640, canonical RepVGG) with seeded random weights and
   BatchNorm state is written as a JAX-format checkpoint manifest; 8
   synthetic 1280x720 images are served through `run_detection_inference`
   at batch 4 in the deploy form, bf16. Both kernel launch counters are
   zeroed just before and read just after; each must have risen. The
   card's decoded predictions are then compared with the same checkpoint
   served in f32 on the CPU (the kernels' plain versions) within absolute
   limits per field group (MODEL_LIMITS). Warm end-to-end throughput is
   (32 - 8) images over the difference of two later calls on 32 and 8
   images, so each call's model load and first batch cancel.
3. kernels: each kernel runs at every shape the serve forward gave it and
   at ragged shapes (matmul M=1025, and K=20 N=5; conv Cin 3 -> Cout 5 at
   7x300, Cin 40 -> Cout 24 at 20x20), in bf16 on the card, against its
   plain version (f32 math, cast to bf16) within |k - p| <= 1e-2 + 1e-2 |p|:
   both round an f32 value to bf16 after summing in different orders, and
   one bf16 ulp is at most 2^-7 of the value. Kernel, plain and library
   (`torch.addmm`/`F.conv2d` + activation, cuDNN/cuBLAS, timed here and
   never used by the port) times are device times from CUDA events, summed
   per serve batch over the main path's launches, beside the bound
   max(bytes / 3.35 TB/s, bf16 FLOPs / 989 TFLOP/s) of the H100 SXM. Each
   shape's line also gives the achieved rate (TFLOP/s for the conv, TB/s
   for the matmul), the multiples of the bound and of the library time,
   and the output tile the C launcher chose.

Output: per-shape lines, then a `{"kernels": [...]}` JSON line, the card's
name and power limit, and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Details go to chiprun_out/chip_smoke.json. Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
NUM_CLASSES = 80
N_IMAGES = 8
WARM_IMAGES = 32
BATCH = 4
SEED = 0
KERNEL_RTOL = KERNEL_ATOL = 1e-2
# card bf16 vs CPU f32 decoded predictions of one batch, (max, mean) of
# |card - cpu| per field group: about 3x what this script read on an H100
# (PERF.md), logits (conf and class) 1.18e-3 and 1.70e-4, boxes (pixels of
# the 1280x720 originals) 0.0722 and 0.00365. Absolute, so the boxes' grid
# offset (up to 1280 px, the same on both sides) does not widen them.
MODEL_LIMITS = {"logits": (3.5e-3, 5e-4), "boxes": (0.22, 0.011)}

KERNELS = {
    "matmul": dict(name="matmul_bias_act", route="cuda",
                   source="vision_conglomerate_torch/csrc/matmul_bias_act.cu",
                   replaces="vision_conglomerate_tpu/ops/fused_matmul.py:39"),
    "conv3x3": dict(name="conv3x3_bias_act", route="cuda",
                    source="vision_conglomerate_torch/csrc/conv3x3_bias_act.cu",
                    replaces="vision_conglomerate_tpu/ops/conv_pallas.py:101"),
}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms. A sleep kernel holds the stream
    while the host queues all iterations, so host launch overhead between
    them does not count."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def build_kernels():
    from vision_conglomerate_torch.ops import _cuda

    t0 = time.time()
    logs = _cuda.build(["matmul_bias_act", "conv3x3_bias_act"])
    print(f"build: {time.time() - t0:.1f} s for {len(logs)} kernel sources (nvcc, sm_90a)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")


def make_inputs(root: str):
    """Checkpoint, config and images of the serve phase, from SEED."""
    from vision_conglomerate_torch.models.detection import DetectionNet
    from vision_conglomerate_torch.nn.blocks import init_weights_, randomize_batchnorm_
    from vision_conglomerate_torch.train.checkpoint import save_checkpoint
    from vision_conglomerate_torch.utils import load_yaml
    from vision_conglomerate_torch.weights import state_dict_to_flax
    from PIL import Image

    config = load_yaml(os.path.join(REPO, "configs", "detection", "config.yaml"))
    anchors = load_yaml(os.path.join(REPO, "configs", "detection", "anchors.yaml"))["anchors"]
    g = torch.Generator().manual_seed(SEED)
    net = DetectionNet(NUM_CLASSES, config["model_config"], anchors=anchors, device="cpu")
    randomize_batchnorm_(init_weights_(net, g), g)
    ckpt = os.path.join(root, "DetectionNet.ckpt.tar")
    save_checkpoint(ckpt, {"LAST_EPOCH": 0, "NUM_CLASSES": NUM_CLASSES,
                           "NETWORK_PARAMS": state_dict_to_flax(net.state_dict())})
    img_dirs = {n: os.path.join(root, f"imgs{n}") for n in (N_IMAGES, WARM_IMAGES)}
    for d in img_dirs.values():
        os.makedirs(d)
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:720, 0:1280]
    for i in range(WARM_IMAGES):
        base = 128 + 100 * np.sin(xx / (40 + 10 * i))[..., None] * np.cos(yy / 60.0)[..., None]
        img = np.clip(base + rng.normal(0, 20, size=(720, 1280, 3)), 0, 255).astype(np.uint8)
        path = os.path.join(img_dirs[WARM_IMAGES], f"img_{i:02d}.png")
        Image.fromarray(img).save(path)
        if i < N_IMAGES:
            os.link(path, os.path.join(img_dirs[N_IMAGES], f"img_{i:02d}.png"))
    return config, ckpt, img_dirs


def serve(config, ckpt, img_dir, storage):
    """One run_detection_inference call at this script's settings;
    returns (host-clock seconds, output dir)."""
    from vision_conglomerate_torch.infer.runner import run_detection_inference

    t0 = time.time()
    out = run_detection_inference(img_dir, ckpt, config, batch_size=BATCH, score_threshold=0.01,
                                  with_summary=True, storage_path=storage, device="cuda")
    torch.cuda.synchronize()
    return time.time() - t0, out


def record_kernel_shapes(model):
    """Forward hooks that list (route, NCHW input shape, Cout, activation)
    of every kernel-routed conv the model runs."""
    from vision_conglomerate_torch.nn.blocks import ConvBNorm, RepVGGBlock, kernel_route

    seen, handles = [], []
    for m in model.modules():
        conv = None
        if isinstance(m, ConvBNorm) and m.folded:
            conv = m.conv
        elif isinstance(m, RepVGGBlock) and m.deploy:
            conv = m.conv_reparam
        route = conv is not None and kernel_route(conv, m.activation)
        if route:
            handles.append(m.register_forward_hook(
                lambda mod, inp, out, r=route, c=conv: seen.append(
                    (r, tuple(inp[0].shape), c.out_channels, mod.activation))))
    return seen, handles


def compare_models(config, ckpt, img_dir):
    """Card (bf16, kernels) vs CPU (f32, plain versions) on one batch; also
    the forward's kernel shapes and its device throughput."""
    from vision_conglomerate_torch.data.inference import InferenceImgDataset
    from vision_conglomerate_torch.infer.runner import detect, load_detection_model

    mc = config["model_config"]
    img_wh = tuple(config["train_config"]["img_config"]["img_wh"])
    ds = InferenceImgDataset(img_dir, img_wh=img_wh)
    t0 = time.time()
    items = [ds[i] for i in range(BATCH)]
    load_ms = (time.time() - t0) / BATCH * 1e3
    imgs = np.stack([a for a, _ in items])
    og_hw = items[0][1].shape[:2]
    t0 = time.time()
    gpu_model, _ = load_detection_model(ckpt, mc, device="cuda")
    torch.cuda.synchronize()
    print(f"serve: model load (checkpoint -> deploy form, bf16 on the card) "
          f"{time.time() - t0:.3f} s")
    cpu_model, _ = load_detection_model(ckpt, mc, device="cpu")
    seen, handles = record_kernel_shapes(gpu_model)
    got = detect(gpu_model, imgs, og_hw)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    want = detect(cpu_model, imgs, og_hw)
    m = 3 * sum((img_wh[0] // s) * (img_wh[1] // s) for s in (8, 16, 32))
    check(tuple(got.shape) == tuple(want.shape) == (BATCH, m, 5 + NUM_CLASSES),
          f"pred shapes {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite predictions on the card")
    stats = {}
    for group, sl in (("logits", slice(0, 1 + NUM_CLASSES)),
                      ("boxes", slice(1 + NUM_CLASSES, 5 + NUM_CLASSES))):
        diff = (got[..., sl].cpu() - want[..., sl]).abs()
        max_lim, mean_lim = MODEL_LIMITS[group]
        stats[group] = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
                            max_ref=want[..., sl].abs().max().item())
        print(f"serve: card bf16 vs cpu f32 {group}: max |d| {diff.max().item():.6g} "
              f"(limit {max_lim:g}), mean |d| {diff.mean().item():.6g} (limit {mean_lim:g}), "
              f"max |ref| {stats[group]['max_ref']:.6g}")
        check(diff.max().item() <= max_lim and diff.mean().item() <= mean_lim,
              f"card predictions differ from the CPU reference in {group}")

    x = torch.from_numpy(imgs).cuda()

    def forward():
        with torch.no_grad():
            gpu_model(x.permute(0, 3, 1, 2), inference=True, og_size=og_hw)

    forward()
    torch.cuda.synchronize()
    iters = 10
    t0 = time.time()
    for _ in range(iters):
        forward()
    torch.cuda.synchronize()
    fwd_ms = (time.time() - t0) / iters * 1e3
    print(f"serve: forward + decode at batch {BATCH}: {fwd_ms:.3f} ms/batch "
          f"= {BATCH / fwd_ms * 1e3:.1f} images/s (host clock, synchronized)")
    host = host_phases(got, items[0][1])
    host["decode_resize_ms_per_image"] = load_ms
    print("serve: host clock, " + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))
    return seen, stats, fwd_ms, host, (gpu_model, forward)


def host_phases(preds, og_img):
    """Host-clock times of the serve loop's other phases, as
    run_detection_inference runs them at this script's settings:
    postprocess + NMS of one batch (on the card, synchronized), and the
    drawing and PNG encode of one image's kept boxes."""
    import io

    from PIL import Image
    from vision_conglomerate_torch.ops.postprocess import postprocess_detections
    from vision_conglomerate_torch.utils.drawing import apply_bboxes

    def post():
        p = postprocess_detections(preds, NUM_CLASSES, iou_threshold=0.35,
                                   score_threshold=0.01, box_allowance=4.0)
        return [t.cpu().numpy() for t in p]

    post()
    t0 = time.time()
    boxes, scores, classes, valid = post()
    nms_ms = (time.time() - t0) * 1e3
    kept = np.concatenate([scores[0][:, None], classes[0][:, None].astype(np.float32),
                           boxes[0]], axis=-1)[valid[0]]
    t0 = time.time()
    img = apply_bboxes(og_img.copy(), kept, box_thickness=2, text_thickness=1)
    draw_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    Image.fromarray(img).save(io.BytesIO(), format="png")
    png_ms = (time.time() - t0) * 1e3
    return {"postprocess_nms_ms_per_batch": nms_ms, "boxes_kept_image0": float(len(kept)),
            "draw_ms_per_image": draw_ms, "png_encode_ms_per_image": png_ms}


def kernel_cases(seen):
    """Distinct kernel shapes of one serve batch with their launch counts,
    plus ragged shapes that the serve path does not give."""
    cases = Counter(seen)
    cases[("matmul", (1, 64, 1025, 1), 64, "silu")] += 0  # M = 1025, not a multiple of 128
    cases[("matmul", (1, 20, 100, 1), 5, "relu")] += 0  # K, N not multiples of 8
    cases[("conv3x3", (1, 3, 7, 300), 5, "silu")] += 0  # Cin, Cout not multiples of 8
    cases[("conv3x3", (1, 40, 20, 20), 24, "silu")] += 0  # 9 * Cin not a multiple of 64
    return cases


def launcher_tile(route, m, n, k):
    """The (BM, BN) tile the C launcher picks for an M x N x K GEMM on card 0."""
    from vision_conglomerate_torch.ops import _cuda, conv3x3, fused_matmul

    name, module = KERNELS[route]["name"], fused_matmul if route == "matmul" else conv3x3
    lib = _cuda.load(name, module._ARGTYPES, 0)
    return _cuda.tile(lib, name, m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)


def run_case(route, shape, cout, act, g):
    from vision_conglomerate_torch.ops.conv3x3 import conv3x3_bias_act, conv3x3_bias_act_plain
    from vision_conglomerate_torch.ops.fused_matmul import (
        apply_activation, matmul_bias_act, matmul_bias_act_plain)

    b, cin, h, w = shape
    dev = "cuda"
    bias = torch.randn(cout, device=dev, generator=g)
    if route == "matmul":
        m = b * h * w
        x = torch.randn(m, cin, device=dev, generator=g).bfloat16()
        # (Cin, Cout) view of a (Cout, Cin) weight, as the serve path passes it
        wt = (torch.randn(cout, cin, device=dev, generator=g) / cin ** 0.5).bfloat16().t()
        kern = lambda: matmul_bias_act(x, wt, bias, act)  # noqa: E731
        plain = lambda: matmul_bias_act_plain(x, wt, bias, act)  # noqa: E731
        lib = lambda: apply_activation(torch.addmm(bias.bfloat16(), x, wt), act)  # noqa: E731
        nbytes = 2 * (m * cin + cin * cout + m * cout) + 4 * cout
        flops = 2 * m * cin * cout
    else:
        x = torch.randn(b, h, w, cin, device=dev, generator=g).bfloat16()
        # HWIO view of a channels_last OIHW weight, as the serve path passes it
        w_oihw = (torch.randn(cout, 3, 3, cin, device=dev, generator=g) / (9 * cin) ** 0.5
                  ).bfloat16().permute(0, 3, 1, 2)
        wt = w_oihw.permute(2, 3, 1, 0)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last
        kern = lambda: conv3x3_bias_act(x, wt, bias, act)  # noqa: E731
        plain = lambda: conv3x3_bias_act_plain(x, wt, bias, act)  # noqa: E731
        lib = lambda: apply_activation(  # noqa: E731
            F.conv2d(x_nchw, w_oihw, bias.bfloat16(), padding=1), act)
        nbytes = 2 * (b * h * w * cin + 9 * cin * cout + b * h * w * cout) + 4 * cout
        flops = 2 * b * h * w * 9 * cin * cout
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    ok = bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all())
    bnd, by = bound_ms(nbytes, flops)
    return dict(route=route, shape=list(shape), cout=cout, act=act, ok=ok,
                max_abs_err=err.max().item(), ms=device_ms(kern), plain_ms=device_ms(plain),
                library_ms=device_ms(lib), bound_ms=bnd, bound_by=by, bytes=nbytes, flops=flops,
                tile=list(launcher_tile(route, b * h * w, cout, cin if route == "matmul" else 9 * cin)))


def kernel_phase(seen, launches):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for (route, shape, cout, act), per_batch in sorted(kernel_cases(seen).items()):
        r = run_case(route, shape, cout, act, g)
        r["launches_per_batch"] = per_batch
        rows.append(r)
        b, cin, h, w = shape
        if route == "matmul":
            desc, rate = f"M={b * h * w} K={cin} N={cout}", f"{r['bytes'] / r['ms'] / 1e9:.3f} TB/s"
        else:
            desc, rate = f"B={b} {h}x{w} {cin}->{cout}", f"{r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s"
        print(f"kernel {KERNELS[route]['name']} {desc} x{per_batch}/batch: "
              f"{r['ms']:.4f} ms = {rate}, {r['ms'] / r['bound_ms']:.1f}x bound "
              f"({r['bound_ms']:.4f} by {r['bound_by']}), {r['ms'] / r['library_ms']:.2f}x library "
              f"({r['library_ms']:.4f}), plain {r['plain_ms']:.4f}, tile {r['tile'][0]}x{r['tile'][1]}, "
              f"max |err| {r['max_abs_err']:.3g} {'ok' if r['ok'] else 'MISMATCH'}")
    for r in rows:
        check(r["ok"], f"{r['route']} kernel disagrees with its plain version at {r['shape']}")
    summary = []
    for route, meta in KERNELS.items():
        mine = [r for r in rows if r["route"] == route]
        check(any(r["launches_per_batch"] for r in mine), f"no main-path shapes for {route}")

        def total(key):
            return sum(r[key] * r["launches_per_batch"] for r in mine)

        by_bytes = sum(r["bound_ms"] * r["launches_per_batch"] for r in mine
                       if r["bound_by"] == "bytes")
        summary.append(dict(
            **meta, launches=launches[route],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if by_bytes >= total("bound_ms") / 2 else "operations",
            library_ms=total("library_ms")))
    return rows, summary


def profile_forward(forward, fwd_ms, path):
    """Device time of the serve forward by kernel; its sum over the forward
    time without the profiler (fwd_ms) is the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    iters = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    table = events.table(sort_by="cuda_time_total", row_limit=25)
    with open(path, "w") as f:
        f.write(table)
    print(table)
    print(f"profile: device busy {busy_ms / iters:.3f} ms per forward = "
          f"{busy_ms / iters / fwd_ms:.1%} of the {fwd_ms:.3f} ms forward without the "
          f"profiler ({wall_ms / iters:.3f} ms with it)")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler table of 3 serve forwards")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs on the GPU only")
    if not os.path.isdir(os.path.join(REPO, "vision_conglomerate_torch", "csrc")):
        fail("run from a checkout of the repository (vision_conglomerate_torch/ not found)")
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    build_kernels()
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    from vision_conglomerate_torch.ops.conv3x3 import conv3x3_bias_act
    from vision_conglomerate_torch.ops.fused_matmul import matmul_bias_act

    with tempfile.TemporaryDirectory() as root:
        config, ckpt, img_dirs = make_inputs(root)
        matmul_bias_act.launches = 0
        conv3x3_bias_act.launches = 0
        seconds, served = serve(config, ckpt, img_dirs[N_IMAGES], os.path.join(root, "out"))
        launches = {"matmul": matmul_bias_act.launches, "conv3x3": conv3x3_bias_act.launches}
        print(f"serve: {N_IMAGES} images 1280x720 at batch {BATCH} through "
              f"run_detection_inference in {seconds:.2f} s = {N_IMAGES / seconds:.2f} images/s "
              f"(smoke figure: the first call in the process, with model load and first-batch "
              f"set-up); launches {launches}")
        for route, n in launches.items():
            check(n > 0, f"the {route} kernel never launched on the main path")
        files = sorted(os.listdir(served))
        check("output.csv" in files and sum(f.endswith(".png") for f in files) == N_IMAGES,
              f"serve outputs missing: {files}")
        t_few, _ = serve(config, ckpt, img_dirs[N_IMAGES], os.path.join(root, "warm_few"))
        t_many, _ = serve(config, ckpt, img_dirs[WARM_IMAGES], os.path.join(root, "warm_many"))
        warm = (WARM_IMAGES - N_IMAGES) / (t_many - t_few)
        print(f"serve: warm end to end {warm:.3f} images/s = {WARM_IMAGES - N_IMAGES} images / "
              f"({t_many:.3f} s for {WARM_IMAGES} - {t_few:.3f} s for {N_IMAGES}); decode, "
              f"resize, forward, NMS, drawing, PNG encode, CSV (host clock)")
        seen, model_stats, fwd_ms, host, (_, forward) = compare_models(
            config, ckpt, img_dirs[N_IMAGES])
        if args.profile:
            profile_forward(forward, fwd_ms, os.path.join(out_dir, "serve_profile.txt"))
    n_batches = -(-N_IMAGES // BATCH)
    for route, n in launches.items():
        per_batch = sum(1 for s in seen if s[0] == route)
        check(n == n_batches * per_batch,
              f"{route}: {n} launches in {n_batches} batches, the forward routes {per_batch}")
    rows, summary = kernel_phase(seen, launches)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, launches=launches, serve_seconds=seconds,
                       images=N_IMAGES, batch=BATCH, warm_images_per_s=warm,
                       warm_seconds={N_IMAGES: t_few, WARM_IMAGES: t_many},
                       forward_ms_per_batch=fwd_ms, host=host,
                       model_vs_cpu=model_stats, cases=rows, kernels=summary), f, indent=1)
    print(json.dumps({"kernels": summary}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
