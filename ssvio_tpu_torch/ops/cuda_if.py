"""IF nodes in the CUDA graphs the port captures: `if_node(pred, body)`
captures `body` into a conditional node that a replay runs only while the
[] bool `pred` on the device is set, and skips otherwise, with no host
read. The local BA's rounds after its inlier-ratio flag are such bodies
(`ops/ba.py::_if_live`).

PyTorch gained a binding for these nodes after the version the card runs,
so the node is made through the CUDA runtime (`csrc/graph_if.cu`, built
and bound with ctypes as the LK kernels are, at first use): a one-thread
kernel on the capturing stream sets the node's condition from `pred`, the
node is appended to the capture, and a stream of its own captures the
body into the node's body graph.

The caching allocator routes a capture's allocations to the graph's
private pool by the capturing stream, and the body is captured on
another. So while a body is captured, this thread's allocations go to a
second private pool (`Bodies.pool`, one a capture), which the graph's
replays use and which is held until the graph is closed. A tensor made
inside a body is scratch: a replay that skips the body leaves it as it
was, so a body writes its results into tensors made before it.

`bodies_of(bodies)` opens the bodies of a capture; `graphs.StaticGraph`
opens it around its warm-up, where each body runs eagerly on the bodies'
stream, and around its capture. `if_node` raises outside it.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import weakref
from typing import Callable

import torch

from ssvio_tpu_torch.ops import _nvcc

SRC = _nvcc.CSRC / "graph_if.cu"

_lib = None
_local = threading.local()


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_nvcc.build(SRC)))
        lib.ssvio_if_begin.argtypes = [ctypes.c_void_p] * 3
        lib.ssvio_if_begin.restype = ctypes.c_int
        lib.ssvio_if_end.argtypes = [ctypes.c_void_p]
        lib.ssvio_if_end.restype = ctypes.c_int
        lib.ssvio_if_error.argtypes = [ctypes.c_int]
        lib.ssvio_if_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} of an IF node: "
                           f"{lib.ssvio_if_error(err).decode()} ({err})")


def _release(index: int, pool) -> None:
    torch._C._cuda_releasePool(index, pool)


class Bodies:
    """The IF nodes' bodies of one capture on `device`: the stream that
    captures them and the private pool of their memory, held from the
    first body until `close()` (or until the object is collected)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.index = (device.index if device.index is not None
                      else torch.cuda.current_device())
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.nodes = 0
        self._release = None

    def close(self) -> None:
        """Give the pool back (after the graph that replays the bodies is
        dropped)."""
        if self._release is not None:
            self._release()


@contextlib.contextmanager
def bodies_of(bodies: Bodies):
    """Run or capture this thread's IF nodes on `bodies` while open: a
    StaticGraph opens it around its warm-up and its capture."""
    outer = getattr(_local, "bodies", None)
    _local.bodies = bodies
    try:
        yield bodies
    finally:
        _local.bodies = outer


def is_open(device: torch.device) -> bool:
    """Whether `bodies_of` is open in this thread for `device`."""
    bodies = getattr(_local, "bodies", None)
    return (bodies is not None and device.type == "cuda"
            and device.index in (None, bodies.index))


def if_node(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """`body()` on the stream of the open `bodies_of`. Under a capture it
    is captured into an IF node on `pred` ([] bool on the capture's
    device): a replay runs the body's kernels only where `pred` is set
    when it reaches the node. Outside one (a graph's warm-up) the body
    runs there eagerly, whatever `pred`, so that its first run on that
    stream (the libraries' handles and workspaces bound to it) is not the
    captured one, as the graph's warm-up is for its own stream. A body may
    hold no memory-allocation node (CUDA refuses the graph): cuSOLVER's
    getrs makes one under capture, so the BA solves without it
    (`ba._solve_lu`)."""
    bodies = getattr(_local, "bodies", None)
    if bodies is None or not is_open(pred.device):
        raise RuntimeError(f"an IF node on {pred.device} runs inside "
                           f"cuda_if.bodies_of() (graphs.StaticGraph)")
    _nvcc.check("pred", pred, torch.bool, (), pred.device)
    outer = torch.cuda.current_stream(pred.device)
    stream = bodies.stream
    if not torch.cuda.is_current_stream_capturing():
        stream.wait_stream(outer)
        with torch.cuda.stream(stream):
            body()
        outer.wait_stream(stream)
        return
    lib = _library()
    _check(lib, lib.ssvio_if_begin(outer.cuda_stream, pred.data_ptr(),
                                   stream.cuda_stream), "the start")
    with torch.cuda.stream(stream):
        torch._C._cuda_beginAllocateCurrentThreadToPool(bodies.index,
                                                        bodies.pool)
        try:
            body()
        finally:
            torch._C._cuda_endAllocateToPool(bodies.index, bodies.pool)
            err = lib.ssvio_if_end(stream.cuda_stream)
    # each begin took a reference to the pool: keep one, until close()
    if bodies._release is None:
        bodies._release = weakref.finalize(bodies, _release, bodies.index,
                                           bodies.pool)
        bodies._release.atexit = False
    else:
        _release(bodies.index, bodies.pool)
    bodies.nodes += 1
    _check(lib, err, "the end of the body")
