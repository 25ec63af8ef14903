"""Landmark-sharded local BA over a process group (port of
`ssvio_tpu/parallel/dist_ba.py`).

The JAX package shards the BA problem's landmark axis over a
`jax.sharding.Mesh` axis and runs `ba.local_ba` under `shard_map`: each
shard's Hessian and gradient terms are combined with `psum`, the small
Schur-reduced camera system is solved on every shard, and the landmark
back-substitution stays local. Here the mesh is a `torch.distributed`
process group with one rank per shard, and `ops/ba.py::local_ba(mesh=...)`
takes the same sums with `all_reduce`, at the same places. Per LM
iteration that is F, Hpp [W,6,6] and bp [W,6]; S_cross [W,W,6,6] and corr
[W,6]; the landmark gain term; and the stop test's step and finiteness:
O(W^2) floats, whatever the landmark count.

Two ways to run it:
- SPMD, as the JAX package runs it: every rank holds its shard
  (`shard_problem`) and calls `distributed_local_ba(mesh, ...)` on it.
- A primary and servers, as the port's System runs it: rank 0 owns the
  SLAM state and calls a `PrimaryBA` on each whole problem. It broadcasts
  the problem, every rank solves its shard, and the shards come back to
  rank 0 as an all_reduce SUM of zero-padded whole-size buffers. Ranks > 0
  run `serve` until rank 0 closes the PrimaryBA. Tracking, keyframes and
  every host decision stay on one rank, so no branch of the host-driven
  step can differ between ranks.

Only broadcast and all_reduce are used: they are the two collectives gloo
runs on CUDA tensors, and gloo is the backend for ranks that share one GPU
(NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ssvio_tpu_torch.frontend import resolve_device
from ssvio_tpu_torch.ops import ba

LM_AXIS = "lm"


class Mesh(NamedTuple):
    """A 1-D mesh over the landmark axis: one rank of `group` a shard."""
    group: Optional[dist.ProcessGroup]   # None: the default process group
    rank: int                            # this rank, within `group`
    size: int
    device: torch.device                 # where this rank's shard lives

    @property
    def shape(self) -> dict:
        return {LM_AXIS: self.size}


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh over the ranks of `group` (None: the default process group,
    which must be initialized: `multihost.initialize` or
    `multihost.global_mesh`), with this rank's shard on `device` (the
    current CUDA device unless one is given)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.multihost.initialize)")
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a rank of the group")
    return Mesh(group, rank, dist.get_world_size(group),
                resolve_device(device))


def problem_specs() -> ba.LocalBAProblem:
    """Which LocalBAProblem fields are split over the mesh on dim 0
    (LM_AXIS) and which every rank holds whole (None)."""
    return ba.LocalBAProblem(
        kf_T_cw=None, kf_valid=None, kf_fixed=None,
        lm_pos=LM_AXIS, lm_valid=LM_AXIS, lm_fixed=LM_AXIS,
        obs_uv=LM_AXIS, obs_valid=LM_AXIS)


def result_specs() -> ba.LocalBAResult:
    return ba.LocalBAResult(kf_T_cw=None, lm_pos=LM_AXIS,
                            obs_valid=LM_AXIS, chi2=LM_AXIS,
                            inlier_ratio=None)


def _rows(mesh: Mesh, M: int) -> slice:
    if M % mesh.size:
        raise ValueError(f"the landmark capacity {M} is not divisible by "
                         f"the mesh's {mesh.size} ranks")
    n = M // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_problem(mesh: Mesh, prob: ba.LocalBAProblem) -> ba.LocalBAProblem:
    """This rank's part of a whole problem, on its device: rows
    [r*M/n, (r+1)*M/n) of the landmark fields, the pose fields whole.
    Raises ValueError when M is not divisible by the mesh size."""
    rows = _rows(mesh, prob.lm_pos.shape[0])
    return ba.LocalBAProblem(*[
        (x[rows] if spec else x).to(mesh.device)
        for x, spec in zip(prob, problem_specs())])


def distributed_local_ba(mesh: Mesh, fx, fy, cx, cy, baseline,
                         max_rounds: int = 5, iters: int = 10):
    """The sharded local BA: a function shard -> LocalBAResult that every
    rank of the mesh calls together, each on its shard_problem. The poses
    and the inlier ratio come out equal on every rank; lm_pos, obs_valid
    and chi2 are the shard's (result_specs)."""
    return functools.partial(ba.local_ba, fx=fx, fy=fy, cx=cx, cy=cy,
                             baseline=baseline, max_rounds=max_rounds,
                             iters=iters, mesh=mesh)


# ---------------------------------------------------------------------------
# A primary and servers
# ---------------------------------------------------------------------------

_FLOAT_FIELDS = ("kf_T_cw", "lm_pos", "obs_uv")
_BOOL_FIELDS = ("kf_valid", "kf_fixed", "lm_valid", "lm_fixed", "obs_valid")


def _shapes(W: int, M: int, C: int) -> dict:
    return dict(kf_T_cw=(W, 3, 4), kf_valid=(W,), kf_fixed=(W,),
                lm_pos=(M, 3), lm_valid=(M,), lm_fixed=(M,),
                obs_uv=(M, W, C, 2), obs_valid=(M, W, C))


def _broadcast(mesh: Mesh, t: torch.Tensor):
    root = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    dist.broadcast(t, src=root, group=mesh.group)


def _exchange(mesh: Mesh, step, prob: Optional[ba.LocalBAProblem] = None):
    """One local BA over the mesh, entered by every rank together: rank 0
    passes the whole problem (None: the stop), the others None. Returns
    the whole LocalBAResult on every rank, or None on the stop."""
    dev = mesh.device
    hdr = torch.zeros(4, dtype=torch.int64, device=dev)  # go, W, M, C
    if mesh.rank == 0 and prob is not None:
        M, W, C = prob.obs_valid.shape
        hdr = torch.tensor([1, W, M, C], dtype=torch.int64, device=dev)
    _broadcast(mesh, hdr)
    go, W, M, C = hdr.tolist()
    if not go:
        return None
    rows = _rows(mesh, M)
    shapes = _shapes(W, M, C)
    bufs = []
    for names, dtype in ((_FLOAT_FIELDS, torch.float32),
                         (_BOOL_FIELDS, torch.uint8)):
        if mesh.rank == 0:
            buf = torch.cat([getattr(prob, k).reshape(-1).to(dev, dtype)
                             for k in names])
        else:
            n = sum(torch.Size(shapes[k]).numel() for k in names)
            buf = torch.empty(n, dtype=dtype, device=dev)
        _broadcast(mesh, buf)
        bufs.append(buf)
    fields = {}
    for names, buf in zip((_FLOAT_FIELDS, _BOOL_FIELDS), bufs):
        segs = torch.split(buf, [torch.Size(shapes[k]).numel() for k in names])
        for k, seg in zip(names, segs):
            x = seg.view(shapes[k])
            fields[k] = x if buf.dtype == torch.float32 else x.bool()
    res = step(shard_problem(mesh, ba.LocalBAProblem(**fields)))

    # the shards back to every rank: zero-padded to the whole size, summed
    n = rows.stop - rows.start
    out = torch.zeros((M, 3 + 2 * W * C), dtype=torch.float32, device=dev)
    out[rows] = torch.cat([res.lm_pos,
                           res.obs_valid.reshape(n, -1).to(torch.float32),
                           res.chi2.reshape(n, -1)], dim=1)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    lm_pos, obs_valid, chi2 = torch.split(out, [3, W * C, W * C], dim=1)
    return ba.LocalBAResult(res.kf_T_cw, lm_pos.contiguous(),
                            obs_valid.reshape(M, W, C) > 0.5,
                            chi2.reshape(M, W, C), res.inlier_ratio,
                            res.rounds, res.iterations)


class PrimaryBA:
    """Rank 0's local BA over the mesh: a whole LocalBAProblem in, the
    whole LocalBAResult out, solved by every rank of the mesh on its shard
    (the others run `serve`). `n_solves` counts the problems solved.
    `close()` stops the servers; a failure in the middle of a solve leaves
    the ranks out of step, so the PrimaryBA then refuses further use and
    sends no stop (the servers' collectives end at the group's timeout)."""

    def __init__(self, mesh: Mesh, fx, fy, cx, cy, baseline):
        if mesh.rank != 0:
            raise ValueError("the primary is rank 0 of the mesh; the other "
                             "ranks run dist_ba.serve")
        self.mesh = mesh
        self._step = distributed_local_ba(mesh, fx, fy, cx, cy, baseline)
        self.n_solves = 0
        self._open = True

    @torch.no_grad()
    def __call__(self, prob: ba.LocalBAProblem) -> ba.LocalBAResult:
        if not self._open:
            raise RuntimeError("PrimaryBA: the servers were stopped, or a "
                               "solve failed midway")
        _rows(self.mesh, prob.lm_pos.shape[0])   # before any collective
        self._open = False
        res = _exchange(self.mesh, self._step, prob)
        self._open = True
        self.n_solves += 1
        return res

    def close(self):
        """Stop the servers (once; nothing after a failed solve)."""
        if self._open:
            self._open = False
            _exchange(self.mesh, None)


@torch.no_grad()
def serve(mesh: Mesh, fx, fy, cx, cy, baseline) -> int:
    """Ranks > 0: solve this rank's shard of every problem rank 0's
    PrimaryBA sends, until it stops. The camera must be rank 0's; the LM
    schedule is local_ba's default on every rank. Returns the number of
    problems served."""
    if mesh.rank == 0:
        raise ValueError("rank 0 is the primary (PrimaryBA); serve runs on "
                         "the other ranks")
    step = distributed_local_ba(mesh, fx, fy, cx, cy, baseline)
    n = 0
    while _exchange(mesh, step) is not None:
        n += 1
    return n
