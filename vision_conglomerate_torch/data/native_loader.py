"""ctypes bindings for the port's native host-side decode + resize library,
the JAX package's data/native_loader.py for the port.

`csrc/vct_data.cc` decodes JPEG and PNG (sniffed per item) with libjpeg and
libpng on a C++ thread pool and resizes straight into a uint8 NHWC buffer,
with the GIL released. Two resize modes:
- "bilinear": half-pixel-center bilinear (cv2.INTER_LINEAR), for serving;
- "pil": PIL's antialiased bicubic (uint8 between the passes, as PIL's
  fixed point; within 1 LSB of PIL), for the train datasets
  (`DetectionDataset(decode_backend="native")`).

At first use the source is compiled with g++ into this package's
git-ignored `_build/libvctdata-<hash>.so` (the hash is of the source and
the flags): under a file lock, so that parallel processes build it once,
to a temporary name that is then renamed into place. Nothing is written
outside `_build/`. `native_available()` says whether the library builds and
loads; `NativeImageDecoder()` raises when it does not.
"""
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PACKAGE, "csrc", "vct_data.cc")
BUILD_DIR = os.path.join(PACKAGE, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LINK_FLAGS = ["-ljpeg", "-lpng", "-lpthread"]

_RESIZE_MODES = {"bilinear": 0, "pil": 1}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libvctdata-{digest.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    """Compile the library to `out`, once across processes."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libvctdata.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it meanwhile
            return
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LINK_FLAGS],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(proc.stdout + proc.stderr)
        os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if it cannot be
    (the reason is kept for the error message)."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        try:
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _build_error = str(e)
            return None
        lib.vct_decode_resize_mode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.vct_decode_resize_mode.restype = ctypes.c_int
        lib.vct_decode_resize_batch_mode.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
        lib.vct_decode_resize_batch_mode.restype = ctypes.c_int
        lib.vct_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.vct_probe.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    """True if the C++ decode library builds (or is built) and loads."""
    return _load() is not None


def _wh(out_wh: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (out_wh, out_wh) if isinstance(out_wh, int) else tuple(out_wh)


class NativeImageDecoder:
    """Decode JPEG/PNG bytes and resize on the host with csrc/vct_data.cc.

    Every call releases the GIL for the C call; the batch call also spreads
    the decodes over a C++ thread pool of `n_threads` (<= 0: one per
    hardware thread).
    """

    def __init__(self, n_threads: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "the native decode library (vision_conglomerate_torch/csrc/vct_data.cc) "
                f"did not build or load; it needs g++ and the system libjpeg and libpng "
                f"headers and libraries:\n{_build_error}")
        self._lib = lib
        self.n_threads = n_threads

    def probe(self, data: bytes) -> Tuple[int, int]:
        """(width, height) of an encoded image without a full decode."""
        w, h = ctypes.c_int(), ctypes.c_int()
        if self._lib.vct_probe(data, len(data), ctypes.byref(w), ctypes.byref(h)):
            raise ValueError("not a decodable JPEG/PNG buffer")
        return w.value, h.value

    def decode_resize(self, data: bytes, out_wh: Union[int, Tuple[int, int]],
                      resize: str = "bilinear") -> np.ndarray:
        """Decode one image and resize it to (w, h): uint8 RGB (h, w, 3)."""
        w, h = _wh(out_wh)
        out = np.empty((h, w, 3), dtype=np.uint8)
        if self._lib.vct_decode_resize_mode(
                data, len(data), w, h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                _RESIZE_MODES[resize]):
            raise ValueError("not a decodable JPEG/PNG buffer")
        return out

    def decode_resize_batch(self, blobs: Sequence[bytes], out_wh: Union[int, Tuple[int, int]],
                            resize: str = "bilinear",
                            out: Optional[np.ndarray] = None) -> np.ndarray:
        """Decode a batch into one (n, h, w, 3) uint8 buffer (`out`, if
        given). A failed decode leaves its slot zeroed, and the call raises
        after the whole batch, so one bad file does not strand the pool."""
        w, h = _wh(out_wh)
        n = len(blobs)
        if out is None:
            out = np.empty((n, h, w, 3), dtype=np.uint8)
        elif out.shape != (n, h, w, 3) or out.dtype != np.uint8:
            raise ValueError(f"out must be uint8 {(n, h, w, 3)}, got {out.dtype} {out.shape}")
        ptrs = (ctypes.c_char_p * n)(*blobs)
        lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
        failures = self._lib.vct_decode_resize_batch_mode(
            ptrs, lens, n, w, h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.n_threads, _RESIZE_MODES[resize])
        if failures:
            raise ValueError(f"{failures}/{n} images failed to decode")
        return out


def decode_file(path: str, out_wh, resize: str = "bilinear") -> np.ndarray:
    """Read, decode and resize one file."""
    with open(path, "rb") as f:
        return NativeImageDecoder().decode_resize(f.read(), out_wh, resize)
