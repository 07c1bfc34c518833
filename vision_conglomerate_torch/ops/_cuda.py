"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled
with nvcc for `sm_90a` into `_build/lib<name>-<hash>.so` inside this package
(git-ignored; the hash is of the source and the shared `csrc/*.cuh`
headers, so an edited source builds anew) and loaded with ctypes. The
kernels launch on the stream the wrapper passes, on the current device
(the wrapper holds a `torch.cuda.device` guard), and return
`cudaGetLastError()`, which the wrapper turns into an exception.
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Set, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_READY: Set[Tuple[str, int]] = set()  # (library, device) pairs whose init has run


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return path


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu"), *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no library yet, one nvcc process
    each, all started together. Returns {name: compiler output}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load(name: str, argtypes: Dict[str, List], device: int) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed, and
    set up for `device`, which must be the current device.

    `argtypes` maps each exported launch function to its ctypes argument
    types: `c_void_p` for every pointer and the stream (a bare int would be
    cut to 32 bits), `c_int` for sizes. Each returns a CUDA error code; the
    library also exports `<name>_error_string(int) -> const char*`. A
    library that needs per-device set-up exports `int <name>_init(void)`,
    which runs once for each device.
    """
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            for fn, types in argtypes.items():
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
        if (name, device) not in _READY:
            if hasattr(lib, f"{name}_init"):
                init = getattr(lib, f"{name}_init")
                init.argtypes, init.restype = [], ctypes.c_int
                check(lib, name, init())
            _READY.add((name, device))
        return lib


# argtypes of each library's `<name>_tile(M, N, K, sms, *bm, *bn)`
TILE_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2


def tile(lib: ctypes.CDLL, name: str, m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """The (BM, BN) output tile that library `name`'s launcher picks for an
    M x N x K GEMM on a card of `sms` SMs."""
    bm, bn = ctypes.c_int(), ctypes.c_int()
    check(lib, name, getattr(lib, f"{name}_tile")(m, n, k, sms, ctypes.byref(bm), ctypes.byref(bn)))
    return bm.value, bn.value


def check(lib: ctypes.CDLL, name: str, code: int):
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel: CUDA error {code} ({msg})")
