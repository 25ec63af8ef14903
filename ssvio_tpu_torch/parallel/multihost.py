"""Joining the processes of a multi-process run into one process group
(port of `ssvio_tpu/parallel/multihost.py`).

The JAX package joins its processes with `jax.distributed.initialize` and
builds one mesh over every process's devices. Here the processes join one
`torch.distributed` process group, one rank each, and the mesh is that
group (`dist_ba.Mesh`).

Wiring:
  * programmatic: `multihost.initialize(coordinator, num_processes,
    process_id)` before the mesh is built;
  * environment-driven (what `scripts/torch_run_kitti.py --distributed`
    uses): SSVIO_COORDINATOR=host:port  SSVIO_NUM_PROCESSES=N
    SSVIO_PROCESS_ID=k, or torchrun's MASTER_ADDR/MASTER_PORT/RANK/
    WORLD_SIZE, which play the part of JAX's cluster auto-detection.

Backends: NCCL for ranks on CUDA devices of their own, gloo on the CPU and
for ranks that share one GPU (NCCL refuses two ranks on one device; gloo
runs broadcast and all_reduce, all the BA needs, on CUDA tensors). The
backend is what the caller names, or NCCL where CUDA is available and
gloo elsewhere: a backend that fails to start raises, and no other is
tried.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ssvio_tpu_torch.frontend import resolve_device
from ssvio_tpu_torch.parallel import dist_ba

ENV_COORD = "SSVIO_COORDINATOR"
ENV_NPROC = "SSVIO_NUM_PROCESSES"
ENV_PID = "SSVIO_PROCESS_ID"
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# A collective that waits longer raises, so that ranks out of step fail
# instead of hanging. Servers wait in one between two local BAs: the
# longest stretch without a keyframe must stay inside it.
TIMEOUT = datetime.timedelta(minutes=30)


def default_backend(device=None) -> str:
    """NCCL for a CUDA device (None: where CUDA is available), else gloo."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join this process into a process group over `tcp://<coordinator>`.

    Arguments default to the SSVIO_* environment variables; without a
    coordinator, torchrun's variables (init_method "env://"); with neither,
    returns False (a single-process run). Where CUDA is available the
    process takes CUDA device LOCAL_RANK (torchrun) or its rank, modulo the
    device count. Returns True when a process group was initialized."""
    coordinator = coordinator or os.environ.get(ENV_COORD)
    if num_processes is None and os.environ.get(ENV_NPROC):
        num_processes = int(os.environ[ENV_NPROC])
    if process_id is None and os.environ.get(ENV_PID):
        process_id = int(os.environ[ENV_PID])

    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError(f"a coordinator needs the number of processes "
                             f"and this process's id ({ENV_NPROC}, "
                             f"{ENV_PID})")
        init_method = f"tcp://{coordinator}"
        rank, world = process_id, num_processes
    elif all(os.environ.get(k) for k in TORCHRUN_ENV):
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        return False
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend or default_backend(),
                            init_method=init_method, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    return True


def global_mesh(device=None) -> dist_ba.Mesh:
    """The 1-D mesh over every rank of the process group, with this rank's
    shard on `device` (the current CUDA device unless one is given). With
    no process group initialized: a world of 1 in this process (an
    in-process store), as `jax.devices()` is one process's devices before
    `jax.distributed.initialize`."""
    device = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(default_backend(device),
                                store=dist.HashStore(), world_size=1,
                                rank=0, timeout=TIMEOUT)
    return dist_ba.make_mesh(device=device)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns the host-side state (the System, its
    keyframe records and loop closing, trajectory export); the others
    serve local BA (`dist_ba.serve`)."""
    return process_index() == 0
