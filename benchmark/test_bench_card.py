"""Card-only tests of the benchmark (marked `gpu`; each skips without a
CUDA device, decided inside the `card` fixture):

- the control of the three numbers that follow the program's own
  problems: on a short window of each cell at its own sizes, the
  program's numbers are within the cell's limits and the reference's
  solvers in TF32, put in the program's place, are not;
- the upper reading of `rpe_m`: the program with every LK call in the
  window returning where it started reads above the cell's limit;
- a short run of each cell through `benchmark/run.py` ends with its
  result line, correct.

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu benchmark/
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import cells

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELLS = ("kitti-straight-offline", "robotcar-street-offline")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_where_the_program_passes(card, workload):
    from benchmark import calibrate
    cell = cells.load(workload)
    (r,) = calibrate.readings(cell, [2 ** 31 + 101], 6.0, card)
    lim = cell.limits
    assert r["track_gap_median"] <= lim["track_gap_median"]
    assert r["ba_gap"] <= lim["ba_gap"]
    assert r["status_errors"] == 0
    assert (r["control.track_gap_median"] > lim["track_gap_median"]
            or r["control.ba_gap"] > lim["ba_gap"])
    for fault in ("unchanged", "half"):
        assert (r[f"fault.{fault}.track_gap_median"] > lim["track_gap_median"]
                or r[f"fault.{fault}.ba_gap"] > lim["ba_gap"])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_lk_that_returns_its_start_fails_the_drive(card, workload):
    from benchmark import calibrate
    cell = cells.load(workload)
    (r,) = calibrate.readings(cell, [2 ** 31 + 103], 10.0, card,
                              fault="lk_start")
    assert r["rpe_m"] > cell.limits["rpe_m"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(card, workload):
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         workload, "--seed", str(2 ** 31 + 202), "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
