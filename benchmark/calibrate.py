"""The readings that the correctness limits of a cell are set from
(`benchmark/limits/<workload>.json`): the program's numbers on many seeds,
and on the same samples the control's (the reference's solvers in TF32,
put in the program's place) and those of planted faults (a step that
returns its state unchanged; half of the tracks or landmarks left out of
the solve). With `--set`, the program runs with those settings changed
(`--set lk_kernel=mm`: its LK in bfloat16). With `--fault lk_start`, every
LK call in the window returns the positions it started from (a step that
returns its state unchanged): the upper reading of `rpe_m`, which the
reference's control cannot give, since it follows the program problem
by problem. The warm-up runs sound; the engine's CUDA graphs are
captured again with the fault in and again without it after the window.

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        --seconds 8 [--set key=value ...] [--fault lk_start] \
        [--out readings.json]

One process, one System: the first seed's set-up trains the vocabulary
and captures the graphs; each later seed renders its drive, warms up and
runs its own short window at the cell's load, then its samples are judged
three ways. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def with_changes(s, changes):
    """The settings `s` with each "key=value" of `changes` applied, the
    value read as the field's type."""
    for item in changes:
        key, value = item.split("=", 1)
        old = getattr(s, key)
        setattr(s, key, type(old)(value) if old is not None else value)
    return s


@contextlib.contextmanager
def lk_returns_its_start(system):
    """Every LK call returns the positions it started from, inside the
    block; the System's graphs are captured again on each side of it."""
    from ssvio_tpu_torch.ops import lk
    orig = lk.track

    def track(pyr_prev, pyr_cur, pts_prev, pts_init, valid, *a, **k):
        _, ok, err = orig(pyr_prev, pyr_cur, pts_prev, pts_init, valid,
                          *a, **k)
        return pts_init, ok, err

    lk.track = track
    system._engine.close()
    try:
        yield
    finally:
        lk.track = orig
        system._engine.close()


FAULTS = {"lk_start": lk_returns_its_start}


def readings(cell, seeds, seconds: float, device, changes=(),
             fault=None) -> list:
    import torch
    from benchmark import cells, harness, judge as judging, traffic
    from ssvio_tpu_torch.system import System
    s = with_changes(cells.settings_from(cell.config), changes)
    tr = cell.traffic
    out = []
    with torch.no_grad():
        sys_ = System(s, enable_backend=s.backend_open,
                      enable_loop_closing=s.loop_closing_open, device=device)
        mode_cls, warmup = harness.MODES[tr["mode"]]
        for seed in seeds:
            t0 = time.perf_counter()
            drive = traffic.make_drive(tr["drive"], seed, s, sys_.w, sys_.h,
                                       device)
            warmup(sys_, drive, tr, len(drive.left))
            run = harness.Run(tr["mode"], s, (sys_.h, sys_.w))
            judge = judging.Judge(s, seed, s.baseline)
            mode = mode_cls(sys_, drive, tr, run, judge, None)
            with (FAULTS[fault](sys_) if fault else contextlib.nullcontext()):
                mode.window(seconds)
            mode.close()
            del mode, drive
            sys_.reset(keep_vocab=True)
            numbers = judge.evaluate(control=True,
                                     faults=True)
            numbers.update(seed=seed, frames=run.frames, lost=run.lost,
                           seconds=time.perf_counter() - t0)
            print(json.dumps(numbers), flush=True)
            out.append(numbers)
        sys_.close()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--set", nargs="*", default=[], dest="changes")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import cells
    from benchmark.run import cache_dirs, require_cards
    cell = cells.load(args.workload)
    require_cards(int(cell.workload["chips"]))
    cache_dirs()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = readings(cell, args.seeds, args.seconds, torch.device("cuda", 0),
                   args.changes, args.fault)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "changes": args.changes,
                       "fault": args.fault,
                       "card": torch.cuda.get_device_name(0), "runs": res},
                      f)
    keys = sorted({k for r in res for k in r
                   if "gap" in k or "err" in k or "rpe" in k})
    summary = {k: [min(r.get(k, float("nan")) for r in res),
                   max(r.get(k, float("nan")) for r in res)] for k in keys}
    print("SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
