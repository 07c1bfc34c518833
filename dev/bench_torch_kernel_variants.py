"""Time design variants of the port's CUDA kernels on one NVIDIA GPU.

    python3 dev/bench_torch_kernel_variants.py                 # every variant
    python3 dev/bench_torch_kernel_variants.py chosen wait0    # some of them
    python3 dev/bench_torch_kernel_variants.py --narrow chosen narrow

Each variant is the committed vision_conglomerate_torch/csrc with text
substitutions in igemm_sm90.cuh (VARIANTS below), built with the port's
nvcc flags into vision_conglomerate_torch/_build/variants/, all variants in
parallel. Every variant runs at each distinct kernel shape of one serve
batch of 4 at 640x640 (SHAPES, with its launches per batch) and at the
ragged shapes that chip_smoke.py also checks. With --narrow it runs
instead the convs whose channel counts are not whole 16-byte chunks, as
the model has them and as the serve form pads them (NARROW_SHAPES:
TrackNet base's enc_0 and dec_8 at batch 32, 640x352, and CSPNet's s2d
stem at batch 4, 640^2), in bf16 and on the s8 conv kernel. Each result
is held against the kernel's plain version (bf16 within 1e-2 + 1e-2 |p|,
s8 within one bf16 ulp) and timed with CUDA events (chip_smoke.device_ms,
50 launches); the cuDNN/cuBLAS call (s8: torch._int_mm on the im2col)
that computes the same function is timed beside it. Prints a line per
shape, then per-batch sums per kernel, and writes
chiprun_out/kernel_variants.json (--narrow: kernel_variants_narrow.json).
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
from vision_conglomerate_torch.ops import _cuda, conv3x3, fused_matmul, int8  # noqa: E402

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
# (route, (B, H, W), Cin, Cout): the narrow convs unpadded, then as the
# serve form runs them (nn/channel_pad.py)
NARROW_SHAPES = [(r, bhw, ci, co) for r in ("conv3x3", "conv3x3_s8") for bhw, ci, co in (
    ((32, 352, 640), 9, 64), ((32, 352, 640), 16, 64),  # TrackNet enc_0
    ((32, 176, 320), 126, 128), ((32, 176, 320), 128, 128),  # TrackNet dec_8
    ((4, 320, 320), 12, 64), ((4, 320, 320), 16, 64))]  # the s2d stem

_TILE = "  if (N > 64 && K >= 2048 && 4 * blocks({64, 128}) >= 3LL * sms) return {64, 128};"
_WAIT = "    wgmma_wait<1>();\n    fence_regs<BN / 2>(acc);\n  }"


def _force(bm, bn):
    return (_TILE, f"  return {{{bm}, {bn}}};")


# the "narrow" variant's text substitutions in igemm_sm90.cuh
NARROW = [
    ("  int M, N, K, H, W, C, act, vec, vec_out;\n",
     "  int M, N, K, H, W, C, act, vec, vec_out, narrow;\n"),
    ("    if (p.vec) {\n      asm volatile(\"prefetch.tensormap",
     "    if (p.vec || p.narrow) {\n      asm volatile(\"prefetch.tensormap"),
    ("""    } else {
      union { uint4 u; typename Operand<T>::Bits h[VALS]; } v;""",
     """    } else if (p.narrow) {
      if (tid == 0) {
        mbar_expect_tx(bars + 8 * stage, BN * ROW_BYTES);
        tma_load_2d(sb, &w_map, kt * BK, n0, bars + 8 * stage);
      }
      fetch_a(kt);
      store_a(stage);
    } else {
      union { uint4 u; typename Operand<T>::Bits h[VALS]; } v;"""),
    ("""  // Copy K tile kt of A and W into ring stage `stage`.
  auto load_tile""",
     """  // Narrow path: K walks 9 taps of CP = K / 9 channels (C rounded up to
  // VALS; W padded per tap by the caller), so a chunk stays in one tap;
  // its values are loaded as scalars into registers (fetch_a) and stored
  // to the stage later (store_a).
  const int CP = K / 9;
  uint4 staged[A_ROWS];
  auto fetch_a = [&](int kt) {
    const int k = kt * BK + VALS * j;
    const int tap = k / CP, c = k - tap * CP;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      union { uint4 u; typename Operand<T>::Bits h[VALS]; } v;
      const bool ok = k < K && (unsigned)(py[i] + dy) < (unsigned)H &&
                      (unsigned)(px[i] + dx) < (unsigned)W;
      const T* src = x + (ok ? ((long long)pix[i] + dy * W + dx) * C + c : 0);
#pragma unroll
      for (int q = 0; q < VALS; ++q) v.h[q] = Operand<T>::bits(ok && c + q < C ? src[q] : zero);
      staged[i] = v.u;
    }
  };
  auto store_a = [&](int stage) {
    const uint32_t sa = ring + stage * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) st_shared16(sa + swizzle128(r0 + i * ROW_STEP, j), staged[i]);
  };

  // Copy K tile kt of A and W into ring stage `stage`.
  auto load_tile"""),
    ("""    if (kt + LOOKAHEAD < k_tiles) load_tile(kt + LOOKAHEAD, (kt + LOOKAHEAD) % STAGES);
    cp_async_commit();
    if (p.vec) mbar_wait(bars + 8 * stage, (kt / STAGES) & 1);""",
     """    const bool ahead = kt + LOOKAHEAD < k_tiles;
    const int ahead_stage = (kt + LOOKAHEAD) % STAGES;
    if (p.narrow) {
      if (ahead && tid == 0) {
        const uint32_t sb_ahead = ring + ahead_stage * STAGE_BYTES + A_BYTES;
        mbar_expect_tx(bars + 8 * ahead_stage, BN * ROW_BYTES);
        tma_load_2d(sb_ahead, &w_map, (kt + LOOKAHEAD) * BK, n0, bars + 8 * ahead_stage);
      }
      if (ahead) fetch_a(kt + LOOKAHEAD);
    } else if (ahead) {
      load_tile(kt + LOOKAHEAD, ahead_stage);
    }
    cp_async_commit();
    if (p.vec || p.narrow) mbar_wait(bars + 8 * stage, (kt / STAGES) & 1);"""),
    ("""    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<BN / 2>(acc);
  }""",
     """    wgmma_commit();
    if (p.narrow && ahead) store_a(ahead_stage);
    wgmma_wait<1>();
    fence_regs<BN / 2>(acc);
  }"""),
    ("  if (p.vec && (!encode<T>(&w_map, p.w, p.N, p.K, BN) ||",
     "  if ((p.vec || p.narrow) && (!encode<T>(&w_map, p.w, p.N, p.K, BN) ||"),
    # the launcher walks K over 9 taps of Cin rounded up to VALS
    ("  const Params<T> p{static_cast<const T*>(x), static_cast<const T*>(w),",
     "  const bool narrow = TAPS == 9 && C % Operand<T>::VALS != 0 && aligned16(w);\n"
     "  if (narrow) K = 9 * ((C + Operand<T>::VALS - 1) / Operand<T>::VALS * Operand<T>::VALS);\n"
     "  const Params<T> p{static_cast<const T*>(x), static_cast<const T*>(w),"),
    ("                    vector_path<T>(x, w, K, C), N % 8 == 0 && aligned16(y)};",
     "                    vector_path<T>(x, w, K, C), N % 8 == 0 && aligned16(y), narrow};"),
]


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
    # an asynchronous path for a conv's Cin that is not a multiple of the
    # values in 16 bytes, in place of the element path: K walks the 9 taps
    # of Cin rounded up to those values (W padded per tap once, by the
    # caller: PER_TAP, so W still comes by TMA), and each thread loads its
    # A chunks as scalars into registers for tile kt + LOOKAHEAD before
    # tile kt's wgmma and stores them to shared memory after issuing it
    "narrow": NARROW,
}
# variants whose conv takes W padded per tap where Cin is narrow
PER_TAP = {"narrow"}
NAMES = {"conv3x3": "conv3x3_bias_act", "matmul": "matmul_bias_act",
         "conv3x3_s8": "conv3x3_s8_bias_act"}
ARGTYPES = {"conv3x3": conv3x3._ARGTYPES, "matmul": fused_matmul._ARGTYPES,
            "conv3x3_s8": int8._CONV_ARGTYPES}
VALUES = {"conv3x3": 8, "matmul": 8, "conv3x3_s8": 16}  # values in 16 bytes


def build(variants, routes):
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
        for route in routes:
            name = NAMES[route]
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
        for fn, types in ARGTYPES[route].items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = types, ctypes.c_int
        getattr(lib, f"{name}_init").restype = ctypes.c_int
        getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        _cuda.check(lib, name, getattr(lib, f"{name}_init")())
        libs[(v, route)] = lib
    return libs


def case(route, bhw, cin, cout, g):
    """(launch(lib, y, per_tap), y, plain result, library call, bound ms)
    of one shape; `per_tap`: the conv's W padded per tap (PER_TAP)."""
    b, h, w = bhw
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bias = torch.randn(cout, device="cuda", generator=g)
    stream = torch.cuda.current_stream().cuda_stream
    tap = lambda wk: F.pad(wk, (0, -cin % VALUES[route])).contiguous()  # noqa: E731
    if route == "conv3x3_s8":
        m = b * h * w
        x = torch.randint(-127, 128, (b, h, w, cin), device="cuda", generator=g, dtype=torch.int8)
        wk = torch.randint(-127, 128, (cout, 3, 3, cin), device="cuda", generator=g,
                           dtype=torch.int8)
        w_tap, hwio = tap(wk), wk.permute(1, 2, 3, 0)
        scale = torch.rand(cout, device="cuda", generator=g) * (4.0 / (127 * 127 * (9 * cin) ** 0.5))
        want = int8.conv3x3_s8_bias_act_plain(x, hwio, scale, bias, "silu", torch.bfloat16).float()
        cols = int8.im2col_s8(x, (3, 3), (1, 1), (1, 1))
        wc = int8.im2col_weights(hwio, cols.shape[1])
        library = lambda: int8.dequantize(  # noqa: E731
            torch._int_mm(cols, wc), scale, bias, "silu", torch.bfloat16)
        launch = lambda lib, y, per_tap: lib.conv3x3_s8_bias_act_s8(  # noqa: E731
            x.data_ptr(), (w_tap if per_tap else wk).data_ptr(), scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), b, h, w, cin, cout, 1, sms, stream)
        y = torch.empty(b, h, w, cout, dtype=torch.bfloat16, device="cuda")
        bound = chip_smoke.bound_ms(m * cin + 9 * cin * cout + 2 * m * cout + 8 * cout,
                                    2 * m * 9 * cin * cout, chip_smoke.PEAK_INT8_OPS)[0]
    elif route == "matmul":
        m = b * h * w
        x = torch.randn(m, cin, device="cuda", generator=g).bfloat16()
        wk = (torch.randn(cout, cin, device="cuda", generator=g) / cin ** 0.5).bfloat16()
        want = fused_matmul.matmul_bias_act_plain(x, wk.t(), bias, "silu").float()
        library = lambda: fused_matmul.apply_activation(  # noqa: E731
            torch.addmm(bias.bfloat16(), x, wk.t()), "silu")
        launch = lambda lib, y, per_tap: lib.matmul_bias_act_bf16(  # noqa: E731
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), y.data_ptr(), m, cout, cin, 1, sms, stream)
        y = torch.empty(m, cout, dtype=torch.bfloat16, device="cuda")
        bound = chip_smoke.bound_ms(2 * (m * cin + cin * cout + m * cout) + 4 * cout,
                                    2 * m * cin * cout)[0]
    else:
        x = torch.randn(b, h, w, cin, device="cuda", generator=g).bfloat16()
        wk = (torch.randn(cout, 3, 3, cin, device="cuda", generator=g) / (9 * cin) ** 0.5).bfloat16()
        w_oihw, w_tap = wk.permute(0, 3, 1, 2), tap(wk)
        want = conv3x3.conv3x3_bias_act_plain(x, w_oihw.permute(2, 3, 1, 0), bias, "silu").float()
        library = lambda: fused_matmul.apply_activation(  # noqa: E731
            F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias.bfloat16(), padding=1), "silu")
        launch = lambda lib, y, per_tap: lib.conv3x3_bias_act_bf16(  # noqa: E731
            x.data_ptr(), (w_tap if per_tap else wk).data_ptr(), bias.data_ptr(), y.data_ptr(), b,
            h, w, cin, cout, 1, sms, stream)
        y = torch.empty(b, h, w, cout, dtype=torch.bfloat16, device="cuda")
        bound = chip_smoke.bound_ms(2 * (b * h * w * cin + 9 * cin * cout + b * h * w * cout)
                                    + 4 * cout, 2 * b * h * w * 9 * cin * cout)[0]
    return launch, y, want, library, bound


def main():
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this tool runs on the GPU only")
    narrow = "--narrow" in sys.argv[1:]
    variants = [a for a in sys.argv[1:] if a != "--narrow"] or list(VARIANTS)
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    t0 = time.time()
    if narrow:
        cases = [(r, bhw, ci, co, 0) for r, bhw, ci, co in NARROW_SHAPES]
    else:
        cases = [(r, (4, hw, hw), ci, co, n) for r, hw, ci, co, n in SHAPES] + [
            (r, bhw, ci, co, 0) for r, bhw, ci, co in RAGGED]
    libs = build(variants, sorted({c[0] for c in cases}))
    print(f"built {len(libs)} libraries in {time.time() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    rows, sums = [], {}
    for route, bhw, cin, cout, per_batch in cases:
        launch, y, want, library, bound = case(route, bhw, cin, cout, g)
        try:  # the yardstick only: cuBLAS takes no int8 GEMM of some shapes
            library_ms = chip_smoke.device_ms(library, 50)
        except RuntimeError:
            library_ms = None
        row = dict(route=route, bhw=list(bhw), cin=cin, cout=cout, launches_per_batch=per_batch,
                   bound_ms=bound, library_ms=library_ms, ms={}, ok={})
        for v in variants:
            lib, per_tap = libs[(v, route)], v in PER_TAP
            y.zero_()
            _cuda.check(lib, NAMES[route], launch(lib, y, per_tap))
            torch.cuda.synchronize()
            d, p = (y.float() - want).abs(), want.abs()
            row["ok"][v] = bool((d <= (chip_smoke.S8_ATOL + chip_smoke.S8_RTOL * p
                                       if route == "conv3x3_s8" else 1e-2 + 1e-2 * p)).all())
            row["ms"][v] = chip_smoke.device_ms(lambda: launch(lib, y, per_tap), 50)
        rows.append(row)
        lib_txt = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{route} {'x'.join(map(str, bhw))} {cin}->{cout} x{per_batch}: library "
              f"{lib_txt}, bound {bound:.4f} | " + " | ".join(
                  f"{v} {row['ms'][v]:.4f}{'' if row['ok'][v] else ' MISMATCH'}" for v in variants),
              flush=True)
        if not per_batch:
            continue
        s = sums.setdefault(route, {"library": 0.0, **{v: 0.0 for v in variants}})
        s["library"] += row["library_ms"] * per_batch
        for v in variants:
            s[v] += row["ms"][v] * per_batch
    for route, s in sums.items():
        print(f"{NAMES[route]} ms per serve batch: " + ", ".join(f"{k} {t:.4f}" for k, t in s.items()))
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    name = "kernel_variants_narrow.json" if narrow else "kernel_variants.json"
    with open(os.path.join(out, name), "w") as f:
        json.dump(dict(card=card, variants={v: VARIANTS[v] for v in variants}, rows=rows,
                       per_batch_ms=sums), f, indent=1)
    bad = [(r["route"], r["bhw"], v) for r in rows for v, ok in r["ok"].items() if not ok]
    if bad:
        raise SystemExit(f"variants disagree with the plain version: {bad}")


if __name__ == "__main__":
    main()
