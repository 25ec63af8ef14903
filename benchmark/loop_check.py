"""The port's pose-graph optimisations on a loop cell's drives, held
against the plain reference (`benchmark/reference_loop.py`), together
with the readings that the cell's correctness limits are set from
(`benchmark/calibrate.py`'s, on the same seeds and windows).

    python benchmark/loop_check.py --workload <cell> --seeds 1 2 3 ... \
        --seconds 20 [--fault pgo_unchanged] [--out readings.json]

`LoopClosing._pose_graph_optimize` is wrapped from the outside, on the
class, for as long as the readings run: each call's problem, as the port
builds it, and the port's solution are copied to the host. After the
runs, each problem is solved by the reference in float64 and, as the
control, in float32 with TF32 products; a problem's gap is (cost of a
solution - the float64 optimum) / the optimum, every cost in float64.
Prints a line a problem and a summary; exits 1 where a port gap reaches
GAP_LIMIT or a control gap stays under it, and says of each seed's
window whether the cell's limits call it `correct`. With `--fault
pgo_unchanged` every PGO of the port returns the poses it was given (a
planted fault: what `correct` makes of a PGO that does nothing). Not part
of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The port's gap against the float64 optimum may not reach this; the
# control's (the reference's own solve in TF32) must. It lies near the
# geometric mean of the two readings on the card's drives: the port's
# largest 1.4e-3 (its float32 LM stops where float32's cost no longer
# resolves a step; 20 iterations or 50 end at the same point) and the
# control's smallest 5.1e-3 (PERF.md section 2).
GAP_LIMIT = 2.5e-3


@contextlib.contextmanager
def captured_pgo(problems: list, unchanged: bool = False):
    """Inside the block every PGO the port runs appends (problem, port's
    solution), both on the host, to `problems`; with `unchanged` the
    port's PGO returns the poses it was given."""
    from ssvio_tpu_torch import loopclosing
    from ssvio_tpu_torch.ops import pgo

    cls = loopclosing.LoopClosing
    orig = cls._pose_graph_optimize
    optimize = pgo.optimize

    def solve_and_keep(prob, *a, **k):
        out = prob.poses.clone() if unchanged else optimize(prob, *a, **k)
        problems.append((pgo.PGOProblem(*(t.detach().cpu() for t in prob)),
                         out.detach().cpu()))
        return out

    def wrapped(self, system):
        pgo.optimize = solve_and_keep
        try:
            return orig(self, system)
        finally:
            pgo.optimize = optimize

    cls._pose_graph_optimize = wrapped
    try:
        yield problems
    finally:
        cls._pose_graph_optimize = orig


def judge_problem(prob, port_poses, device) -> dict:
    """The gaps of the port's solution and of the TF32 control against the
    float64 optimum of one problem."""
    from benchmark import reference as ref
    from benchmark import reference_loop as rl
    t0 = time.perf_counter()
    best = rl.pgo_solve(prob, device=device)
    with ref.precision("tf32"):
        control = rl.pgo_solve(prob, device=device)
    return dict(keyframes=int(prob.pose_valid.sum()),
                edges=int(prob.edge_valid.sum()),
                fixed=int((prob.pose_fixed & prob.pose_valid).sum()),
                cost_start=rl.pgo_cost(prob, prob.poses),
                cost_optimum=best.cost,
                optimum_iterations=best.iterations,
                optimum_converged=best.converged,
                port_gap=ref.gap(rl.pgo_cost(prob, port_poses), best.cost),
                control_gap=ref.gap(control.cost, best.cost),
                seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--fault", choices=["pgo_unchanged"], default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--keep", default=None,
                   help="a .pt file for the problems and the port's solutions")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import calibrate, cells, judge as judging, traffic
    from benchmark.run import cache_dirs, require_cards
    cell = cells.load(args.workload)
    require_cards(int(cell.workload["chips"]))
    cache_dirs()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    problems: list = []
    seed_of: list = []
    make_drive = traffic.make_drive

    seed_now = [None]

    def noting_the_seed(drive, seed, *a, **k):
        # the problems since the last drive are the last seed's
        seed_of.extend([seed_now[0]] * (len(problems) - len(seed_of)))
        seed_now[0] = seed
        return make_drive(drive, seed, *a, **k)

    traffic.make_drive = noting_the_seed
    try:
        with captured_pgo(problems, args.fault == "pgo_unchanged"):
            runs = calibrate.readings(cell, args.seeds, args.seconds, device)
    finally:
        traffic.make_drive = make_drive
    seed_of.extend([seed_now[0]] * (len(problems) - len(seed_of)))
    if args.keep:
        os.makedirs(os.path.dirname(os.path.abspath(args.keep)),
                    exist_ok=True)
        torch.save([(p._asdict(), out, s)
                    for (p, out), s in zip(problems, seed_of)], args.keep)
    gaps = []
    for k, ((prob, port), seed) in enumerate(zip(problems, seed_of)):
        g = judge_problem(prob, port, device)
        g.update(seed=seed, index=k)
        print("PGO " + json.dumps(g), flush=True)
        gaps.append(g)
    summary = dict(workload=args.workload, card=torch.cuda.get_device_name(0),
                   problems=len(gaps), limit=GAP_LIMIT,
                   port_gap_max=max((g["port_gap"] for g in gaps),
                                    default=None),
                   control_gap_min=min((g["control_gap"] for g in gaps),
                                       default=None),
                   corrections={s: sum(g["seed"] == s for g in gaps)
                                for s in args.seeds},
                   fault=args.fault,
                   correct={r["seed"]: judging.verdict(r, cell.limits)[0]
                            for r in runs})
    print("PGO_SUMMARY " + json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, pgo=gaps, runs=runs), f)
    ok = bool(gaps) and all(g["port_gap"] < GAP_LIMIT
                            and g["control_gap"] >= GAP_LIMIT for g in gaps)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
