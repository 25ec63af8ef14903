"""A rank of the port's multi-process tests (tests/test_torch_dist_ba.py,
tests/test_torch_multihost.py, tests/test_torch_profile_tools.py), and
`launch`, which starts them.

Usage: python tests/torch_dist_worker.py <job.pkl> <rank>

Reads the job the test wrote (its mode, the world size, the file store to
meet at, the inputs), joins a gloo process group on the CPU (mode
"multihost": through multihost.initialize and the SSVIO_* variables),
runs the mode and writes this rank's results to out_<rank>.pkl beside
the job. It imports the port and numpy, never jax or the JAX package, and
runs on one torch thread.
"""

import datetime
import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ssvio_tpu_torch.ops import ba  # noqa: E402
from ssvio_tpu_torch.parallel import dist_ba, multihost  # noqa: E402

# a collective that waits longer raises: ranks out of step fail the test
# instead of hanging it
TIMEOUT = datetime.timedelta(seconds=60)


def launch(job: dict, world: int, workdir, timeout: float = 90.0,
           envs=None) -> list:
    """Run `job` on `world` worker processes meeting at a file store in
    `workdir`; returns each rank's results. `envs[r]`: rank r's
    environment. Every worker is killed if one is still running at the
    deadline; a worker that fails fails the caller with its output."""
    workdir = str(workdir)
    path = os.path.join(workdir, "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(job, world=world,
                         init=f"file://{os.path.join(workdir, 'store')}"), f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), path, str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=envs[r] if envs else None) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{out[-4000:]}")
    res = []
    for r in range(world):
        with open(os.path.join(workdir, f"out_{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def _np(t):
    return t.detach().cpu().numpy()


def _problem(d) -> ba.LocalBAProblem:
    return ba.LocalBAProblem(**{k: torch.from_numpy(v) for k, v in d.items()})


def _result(res: ba.LocalBAResult) -> dict:
    return {k: _np(v) for k, v in res._asdict().items()}


def mode_ba(job, mesh):
    """Each problem twice: SPMD (every rank its shard through
    distributed_local_ba), then through rank 0's PrimaryBA with the other
    ranks serving. Returns the shard results, and on rank 0 the whole
    ones (elsewhere, the number of problems served). local_ba's LM
    schedule (5 rounds x 10 iterations) throughout."""
    step = dist_ba.distributed_local_ba(mesh, *job["cam"])
    out = dict(spmd=[_result(step(dist_ba.shard_problem(mesh, _problem(p))))
                     for p in job["problems"]])
    if mesh.rank == 0:
        primary = dist_ba.PrimaryBA(mesh, *job["cam"])
        out["whole"] = [_result(primary(_problem(p)))
                        for p in job["problems"]]
        primary.close()
        out["n_solves"] = primary.n_solves
    else:
        out["served"] = dist_ba.serve(mesh, *job["cam"])
    return out


def run_system(settings, L, R, chunk, mesh=None, device="cpu") -> dict:
    """One System (loop closing off) over the frames: through run_step
    (chunk 0) or run_chunk in chunks of `chunk`, the recorder on. Returns
    its statuses, frame positions, keyframe gids, stats, and the LM steps
    run and rounds skipped that each local BA counts (`engine.ba_work`)
    and that the recorder's chunks counted."""
    from ssvio_tpu_torch import engine
    from ssvio_tpu_torch.system import System
    from ssvio_tpu_torch.utils import profiling
    sys_ = System(settings, enable_loop_closing=False, mesh=mesh,
                  device=device)
    status = []
    t0 = profiling.CLOCK()
    profiling.enable()
    try:
        with torch.no_grad():
            if chunk:
                for a in range(0, len(L), chunk):
                    sys_.run_chunk(L[a:a + chunk], R[a:a + chunk],
                                   [0.1 * i for i in range(a, a + chunk)])
            else:
                for i in range(len(L)):
                    sys_.run_step(L[i], R[i], 0.1 * i)
                    status.append(sys_.status)
    finally:
        profiling.enable(False)
    sys_.close()
    _, est = sys_.frame_trajectory()
    eng = sys_._engine
    return dict(status=status, pos=est[:, :, 3],
                kf_gids=sys_.records.gids(),
                stats={k: v for k, v in sys_.stats.items()
                       if k != "warnings"},
                ba_work=[engine.ba_work(eng.ba_mode, int(t[0]))
                         for t in eng.ba_trips],
                counted={n: sum(c.value for c in profiling.TRACE.counts(n, t0))
                         for n in ("ba.lm_steps_run", "ba.rounds_skipped")})


def mode_system(job, mesh):
    """Rank 0 runs one System per entry of job["chunks"] through the
    mesh; the other ranks serve each one's local BAs."""
    if mesh.rank == 0:
        return [run_system(job["settings"], job["L"], job["R"], c, mesh)
                for c in job["chunks"]]
    return [dist_ba.serve(mesh, *job["cam"]) for _ in job["chunks"]]


def mode_multihost(job, mesh):
    """tests/multihost_worker.py's problem, 1 round x 5 iterations, SPMD."""
    from torch_profile_scaling import build_problem
    prob, cam = build_problem(512, W=8, seed=0)
    step = dist_ba.distributed_local_ba(mesh, *cam, max_rounds=1, iters=5)
    res = step(dist_ba.shard_problem(mesh, prob))
    return dict(kf=_np(res.kf_T_cw), inlier_ratio=float(res.inlier_ratio),
                size=mesh.size, rank=mesh.rank)


def mode_engine(job, mesh):
    """scripts/torch_profile_scaling.py's engine mode at job["M"], one
    timed step: rank 0 returns its last step's pose, keyframe poses and
    landmarks, the others serve."""
    import torch_profile_scaling
    out = torch_profile_scaling.engine_rank(job["M"], mesh, reps=1)
    if out is None:
        return None
    c2 = out[1]
    return dict(T_cw=_np(c2.T_cw), kf_pose=_np(c2.m.kf_pose),
                lm_pos=_np(c2.m.lm_pos))


MODES = dict(ba=mode_ba, system=mode_system, multihost=mode_multihost,
             engine=mode_engine)


def main():
    path, rank = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        job = pickle.load(f)
    if job["mode"] == "multihost":
        if not multihost.initialize():
            raise RuntimeError("multihost.initialize found no SSVIO_* "
                               "variables")
        mesh = multihost.global_mesh("cpu")
    else:
        dist.init_process_group("gloo", init_method=job["init"],
                                world_size=job["world"], rank=rank,
                                timeout=TIMEOUT)
        mesh = dist_ba.make_mesh(device="cpu")
    if mesh.rank != rank or mesh.size != job["world"]:
        raise RuntimeError(f"mesh {mesh} for rank {rank} of {job['world']}")
    with torch.no_grad():
        out = MODES[job["mode"]](job, mesh)
    dist.destroy_process_group()
    with open(os.path.join(os.path.dirname(path), f"out_{rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
