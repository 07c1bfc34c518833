"""Time design variants of the port's two CUDA kernels on one NVIDIA GPU.

    python3 dev/bench_torch_kernel_variants.py                 # every variant
    python3 dev/bench_torch_kernel_variants.py chosen wait0    # some of them

Each variant is the committed vision_conglomerate_torch/csrc with text
substitutions in igemm_sm90.cuh (VARIANTS below), built with the port's
nvcc flags into vision_conglomerate_torch/_build/variants/, all variants in
parallel. Every variant runs at each distinct kernel shape of one serve
batch of 4 at 640x640 (SHAPES, with its launches per batch) and at the
ragged shapes that chip_smoke.py also checks. Each result is held against
the kernel's plain version within 1e-2 + 1e-2 |p| and timed with CUDA
events (chip_smoke.device_ms, 50 launches); the cuDNN/cuBLAS call that
computes the same function is timed beside it. Prints a line per shape,
then per-batch sums per kernel, and writes chiprun_out/kernel_variants.json.
Needs the GPU and nvcc; it is a development tool, not part of the port.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from vision_conglomerate_torch.ops import _cuda, conv3x3, fused_matmul  # noqa: E402

# (route, H = W, Cin, Cout, launches per serve batch of 4)
SHAPES = [("conv3x3", 160, 32, 32, 1), ("conv3x3", 80, 64, 64, 5), ("conv3x3", 40, 128, 128, 6),
          ("conv3x3", 80, 128, 64, 1), ("conv3x3", 20, 256, 256, 6), ("conv3x3", 40, 256, 128, 1),
          ("conv3x3", 80, 320, 128, 1), ("conv3x3", 40, 384, 256, 1), ("conv3x3", 20, 512, 256, 1),
          ("conv3x3", 40, 640, 256, 1), ("conv3x3", 20, 768, 512, 1),
          ("matmul", 160, 32, 32, 3), ("matmul", 80, 64, 64, 2), ("matmul", 160, 64, 64, 1),
          ("matmul", 40, 128, 128, 3), ("matmul", 80, 128, 64, 2), ("matmul", 80, 128, 128, 1),
          ("matmul", 20, 256, 256, 2), ("matmul", 40, 256, 128, 3), ("matmul", 40, 256, 256, 1),
          ("matmul", 20, 512, 256, 5), ("matmul", 20, 512, 512, 2), ("matmul", 20, 1024, 256, 1)]
RAGGED = [("conv3x3", (1, 7, 300), 3, 5), ("conv3x3", (1, 20, 20), 40, 24),
          ("matmul", (1, 100, 1), 20, 5), ("matmul", (1, 1025, 1), 64, 64)]

_TILE = "  if (N > 64 && K >= 2048 && 4 * blocks({64, 128}) >= 3LL * sms) return {64, 128};"
_WAIT = "    wgmma_wait<1>();\n    fence_regs<BN / 2>(acc);\n  }"


def _force(bm, bn):
    return (_TILE, f"  return {{{bm}, {bn}}};")


VARIANTS = {
    "chosen": [],
    # every shape on one tile
    "tile128x64": [_force(128, 64)],
    "tile64x128": [_force(64, 128)],
    "tile64x64": [_force(64, 64)],
    # deep rings at one block per SM
    "ring200k": [("SMEM_BUDGET = 100 * 1024", "SMEM_BUDGET = 200 * 1024")],
    # wgmma of each K tile retired before the next is issued
    "wait0": [(_WAIT, _WAIT.replace("wait<1>", "wait<0>"))],
    # that, with the freed stage copied one tile further ahead
    "ahead3": [(_WAIT, _WAIT.replace("wait<1>", "wait<0>")),
               ("LOOKAHEAD = STAGES - 2;", "LOOKAHEAD = STAGES - 1;")],
    # the deep ring at every K
    "noshallow": [("if (p.K <= 2 * BK) return launch_tile", "if (false) return launch_tile")],
    # the biases read from global memory in the epilogue
    "biasglobal": [("    const float b0 = bias[col], b1 = bias[col + 1];",
                    "    const float b0 = n0 + col < N ? p.bias[n0 + col] : 0.0f,\n"
                    "                b1 = n0 + col + 1 < N ? p.bias[n0 + col + 1] : 0.0f;")],
}
NAMES = {"conv3x3": "conv3x3_bias_act", "matmul": "matmul_bias_act"}
MODULES = {"conv3x3": conv3x3, "matmul": fused_matmul}


def build(variants):
    """{(variant, route): loaded library}, built in parallel."""
    root = os.path.join(_cuda.BUILD_DIR, "variants")
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for v in variants:
        d = os.path.join(root, v)
        shutil.copytree(_cuda.CSRC, d)
        path = os.path.join(d, "igemm_sm90.cuh")
        with open(path) as f:
            src = f.read()
        for old, new in VARIANTS[v]:
            if old not in src:
                raise SystemExit(f"variant {v}: text not found in igemm_sm90.cuh: {old!r}")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src)
        for route, name in NAMES.items():
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", os.path.join(d, f"lib{name}.so"),
                   os.path.join(d, f"{name}.cu")]
            procs[(v, route)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (v, route), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {v} {route}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln and " 0 bytes spill s" not in ln]
        if spills:
            print(f"build {v} {route}: {spills}")
        name = NAMES[route]
        lib = ctypes.CDLL(os.path.join(root, v, f"lib{name}.so"))
        for fn, types in MODULES[route]._ARGTYPES.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = types, ctypes.c_int
        getattr(lib, f"{name}_init").restype = ctypes.c_int
        getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        _cuda.check(lib, name, getattr(lib, f"{name}_init")())
        libs[(v, route)] = lib
    return libs


def case(route, bhw, cin, cout, g):
    """(launch(lib, y), y, plain result, library call, bound ms) of one shape."""
    b, h, w = bhw
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bias = torch.randn(cout, device="cuda", generator=g)
    stream = torch.cuda.current_stream().cuda_stream
    if route == "matmul":
        m = b * h * w
        x = torch.randn(m, cin, device="cuda", generator=g).bfloat16()
        wk = (torch.randn(cout, cin, device="cuda", generator=g) / cin ** 0.5).bfloat16()
        want = fused_matmul.matmul_bias_act_plain(x, wk.t(), bias, "silu").float()
        library = lambda: fused_matmul.apply_activation(  # noqa: E731
            torch.addmm(bias.bfloat16(), x, wk.t()), "silu")
        launch = lambda lib, y: lib.matmul_bias_act_bf16(  # noqa: E731
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), y.data_ptr(), m, cout, cin, 1, sms, stream)
        y = torch.empty(m, cout, dtype=torch.bfloat16, device="cuda")
        bound = chip_smoke.bound_ms(2 * (m * cin + cin * cout + m * cout) + 4 * cout,
                                    2 * m * cin * cout)[0]
    else:
        x = torch.randn(b, h, w, cin, device="cuda", generator=g).bfloat16()
        wk = (torch.randn(cout, 3, 3, cin, device="cuda", generator=g) / (9 * cin) ** 0.5).bfloat16()
        w_oihw = wk.permute(0, 3, 1, 2)
        want = conv3x3.conv3x3_bias_act_plain(x, w_oihw.permute(2, 3, 1, 0), bias, "silu").float()
        library = lambda: fused_matmul.apply_activation(  # noqa: E731
            F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias.bfloat16(), padding=1), "silu")
        launch = lambda lib, y: lib.conv3x3_bias_act_bf16(  # noqa: E731
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), y.data_ptr(), b, h, w, cin, cout, 1, sms,
            stream)
        y = torch.empty(b, h, w, cout, dtype=torch.bfloat16, device="cuda")
        bound = chip_smoke.bound_ms(2 * (b * h * w * cin + 9 * cin * cout + b * h * w * cout)
                                    + 4 * cout, 2 * b * h * w * 9 * cin * cout)[0]
    return launch, y, want, library, bound


def main():
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this tool runs on the GPU only")
    variants = sys.argv[1:] or list(VARIANTS)
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    t0 = time.time()
    libs = build(variants)
    print(f"built {len(libs)} libraries in {time.time() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    rows, sums = [], {}
    cases = [(r, (4, hw, hw), ci, co, n) for r, hw, ci, co, n in SHAPES] + [
        (r, bhw, ci, co, 0) for r, bhw, ci, co in RAGGED]
    for route, bhw, cin, cout, per_batch in cases:
        launch, y, want, library, bound = case(route, bhw, cin, cout, g)
        row = dict(route=route, bhw=list(bhw), cin=cin, cout=cout, launches_per_batch=per_batch,
                   bound_ms=bound, library_ms=chip_smoke.device_ms(library, 50), ms={}, ok={})
        for v in variants:
            lib = libs[(v, route)]
            y.zero_()
            _cuda.check(lib, NAMES[route], launch(lib, y))
            torch.cuda.synchronize()
            row["ok"][v] = bool(((y.float() - want).abs() <= 1e-2 + 1e-2 * want.abs()).all())
            row["ms"][v] = chip_smoke.device_ms(lambda: launch(lib, y), 50)
        rows.append(row)
        print(f"{route} {'x'.join(map(str, bhw))} {cin}->{cout} x{per_batch}: library "
              f"{row['library_ms']:.4f} ms, bound {bound:.4f} | " + " | ".join(
                  f"{v} {row['ms'][v]:.4f}{'' if row['ok'][v] else ' MISMATCH'}" for v in variants),
              flush=True)
        s = sums.setdefault(route, {"library": 0.0, **{v: 0.0 for v in variants}})
        s["library"] += row["library_ms"] * per_batch
        for v in variants:
            s[v] += row["ms"][v] * per_batch
    for route, s in sums.items():
        print(f"{NAMES[route]} ms per serve batch: " + ", ".join(f"{k} {t:.4f}" for k, t in s.items()))
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "kernel_variants.json"), "w") as f:
        json.dump(dict(card=card, variants={v: VARIANTS[v] for v in variants}, rows=rows,
                       per_batch_ms=sums), f, indent=1)
    bad = [(r["route"], r["bhw"], v) for r in rows for v, ok in r["ok"].items() if not ok]
    if bad:
        raise SystemExit(f"variants disagree with the plain version: {bad}")


if __name__ == "__main__":
    main()
