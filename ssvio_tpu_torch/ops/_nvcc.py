"""Build and input checks shared by every hand-written CUDA kernel of the
port (`csrc/*.cu`, each bound with ctypes by its wrapper in `ops/`).

A kernel's library is compiled at first use with nvcc for sm_90a into
`build/ssvio_tpu_torch/`, keyed on a hash of its source, the `csrc/*.cuh`
headers and the flags, so a stale library is never loaded. There is no
fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ssvio_tpu_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_CUDA_ROOTS = ("/usr/local/cuda",)   # searched after PATH and $CUDA_HOME
# the largest window each kernel takes, by launch counter: the JAX
# kernels' limits. csrc/lk_klt.cuh holds 4 pixels a lane for win <= 11, 8
# for <= 16, 18 for <= 24. Kernels #1 and #2: 24, the largest window the
# JAX kernels' 32-row slab holds at every row offset (lk_pallas.py:281-288,
# :60-65; JAX's serial kernel has no guard and wraps above it); #3: 23,
# JAX's `sw` assert; #4 and #5: 16, JAX's `pk` assert and the 16-wide
# blocks of JAX's `mm`
MAX_WIN = {"lk_level": 24, "lk_patch": 24, "lk_level_sw": 23,
           "lk_level_pk": 16, "lk_level_mm": 16, "lk_level_mm_f32": 16}

build_info: dict = {}     # source stem -> path, seconds, ptxas log


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), *_CUDA_ROOTS):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels (csrc/*.cu) cannot be built")


def build(src: Path) -> Path:
    """Compile one csrc/*.cu into build/ssvio_tpu_torch/. Records path,
    nvcc seconds and log under build_info[src.stem]. Returns the library
    path; raises if nvcc is missing or fails."""
    code = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    key = hashlib.sha256(code + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"lib{src.stem}_{key}.so"
    if out.exists():      # built earlier (this process keeps its log)
        build_info.setdefault(src.stem, dict(path=str(out), seconds=0.0,
                                             log="(cached)"))
        return out
    nvcc = find_nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_info[src.stem] = dict(path=str(out), seconds=time.perf_counter() - t0,
                                log=(proc.stdout + proc.stderr).strip())
    return out


def check_window(kernel: str, win: int) -> None:
    """Raise unless `kernel` (a key of MAX_WIN) takes a win x win window."""
    if not 1 <= win <= MAX_WIN[kernel]:
        raise ValueError(f"{kernel}: win={win} outside 1..{MAX_WIN[kernel]}")


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless `t` is what a kernel reads through its raw pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
