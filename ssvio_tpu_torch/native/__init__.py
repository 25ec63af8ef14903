"""ctypes bindings for the port's native host runtime: a PNG/PGM decoder
and a prefetching stereo loader (`dataloader.cpp`, a copy of the JAX
package's `ssvio_tpu/native/`).

The library is built with g++ at first use into `build/ssvio_tpu_torch/`
at the root of the checkout, named by a hash of its source and flags, and
written under a temporary name that is then renamed into place: a stale
library is never loaded, and processes that build at once (test workers)
each finish their own copy and load whichever landed. It needs g++ and
zlib's header and library. There is no fallback: when the library cannot
be built, `load()` raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ssvio_tpu_torch"
_CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
MAX_BYTES = 8 << 20          # the largest decoded image, in pixels

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of this source is built."""
    key = hashlib.sha256(SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"lib_ssvio_native_{key}.so"


def build() -> Path:
    """Compile dataloader.cpp with g++ unless this source's library is
    already built. Returns its path; raises RuntimeError with the
    compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_CXX_FLAGS, str(SRC), "-o", tmp,
                               "-lz", "-lpthread"], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"the native loader ({SRC}) did not build "
                               f"(g++ exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.ssv_decode_file_gray.argtypes = [ctypes.c_char_p, u8p, ctypes.c_long,
                                         ip, ip]
    lib.ssv_decode_file_gray.restype = ctypes.c_int
    lib.ssv_decode_gray.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long,
                                    ip, ip]
    lib.ssv_decode_gray.restype = ctypes.c_int
    lib.ssv_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ssv_loader_create.restype = ctypes.c_void_p
    lib.ssv_loader_next.argtypes = [ctypes.c_void_p, u8p, u8p, ctypes.c_long,
                                    ip, ip]
    lib.ssv_loader_next.restype = ctypes.c_int
    lib.ssv_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.ssv_loader_destroy.restype = None
    return lib


def load() -> ctypes.CDLL:
    """The native library, built on first use. Raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_gray(path: str) -> np.ndarray:
    """Decode one PNG/PGM file to a float32 [H, W] luma array in [0, 255]."""
    lib = load()
    out = np.empty(MAX_BYTES, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.ssv_decode_file_gray(str(path).encode(), _u8p(out), MAX_BYTES,
                                  ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"decode failed ({rc}): {path}")
    return out[:w.value * h.value].reshape(h.value, w.value).astype(
        np.float32)


class StereoLoader:
    """In-order stereo pairs (float32 [H, W] each) decoded ahead of the
    consumer by `n_threads` native workers into a ring of `capacity`
    pairs. A pair that fails to decode is skipped. Close it, or exhaust
    it, to stop the workers."""

    def __init__(self, left: Sequence[str], right: Sequence[str],
                 n_threads: int = 4, capacity: int = 8):
        self._h = None
        if len(left) != len(right):
            raise ValueError(f"{len(left)} left images but {len(right)} "
                             "right ones")
        self._lib = load()
        if not len(left):
            return
        # ctypes arrays the native loader reads for its whole life
        self._larr = (ctypes.c_char_p * len(left))(
            *[str(p).encode() for p in left])
        self._rarr = (ctypes.c_char_p * len(right))(
            *[str(p).encode() for p in right])
        self._bl = np.empty(MAX_BYTES, np.uint8)
        self._br = np.empty(MAX_BYTES, np.uint8)
        self._h = self._lib.ssv_loader_create(self._larr, self._rarr,
                                              len(left), n_threads, capacity)
        if not self._h:
            raise RuntimeError("native loader creation failed")

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        w, h = ctypes.c_int(), ctypes.c_int()
        while self._h is not None:
            rc = self._lib.ssv_loader_next(self._h, _u8p(self._bl),
                                           _u8p(self._br), MAX_BYTES,
                                           ctypes.byref(w), ctypes.byref(h))
            if rc == -1:
                break
            if rc == -2:      # decode failure: skip the frame
                continue
            if rc == -3:
                raise ValueError("image larger than the loader's buffer")
            n = w.value * h.value
            return (self._bl[:n].reshape(h.value, w.value).astype(np.float32),
                    self._br[:n].reshape(h.value, w.value).astype(np.float32))
        self.close()
        raise StopIteration

    def close(self):
        if self._h is not None:
            self._lib.ssv_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
