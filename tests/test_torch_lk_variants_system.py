"""The slice with the "mm" LK flavour: the port's System against the JAX
System, both on `Settings.lk_kernel = "mm"`, on the CPU.

The JAX side runs its Pallas variant `lk_level_vmem_mm` in interpret mode
(`lk_backend="pallas_interpret"`), the port the kernel's plain version
(`lk_backend="ref"`, `lk_variants_cuda.lk_level_mm_ref`): every LK level of
both runs is the bf16 lockstep-group function. The frames are the 620x188
sequence of tests/test_engine_chunked.py, rendered by the port's renderer
as tests/test_torch_engine.py does; both run `run_step` with local BA on
and loop closing off, up to and including the first steady keyframe.

Two runs, frame by frame in lockstep up to and including the first steady
keyframe, or the first frame whose statuses differ, or MAX_FRAMES:

- tracking_good raised from 50 to 62, so that the inlier counts stay at
  least 4 away from it on every frame (106, 82-83, 75, 66-67, then 57 at
  the steady keyframe of frame 5; CPU run of both packages). Statuses and
  keyframes must be equal; per-frame camera positions within
  tests/test_engine_chunked.py's 5e-2 m (float32 summation order in LK, LM
  and BA moves a pose by ~1e-4 m per frame; a different inlier set or
  keyframe moves it by decimetres).
- the default tracking_good, 50. There frame 6 sits on the edge: 49
  inliers in the port, 51 in the JAX package. mm's bf16 windows keep most
  tracks stepping to the iteration cap (tests/test_torch_lk_variants.py),
  where a one-ulp difference can take a track elsewhere, so a few of the
  forward-backward-gated inliers differ between two correct runs (up to 2
  on these frames), and a status at the threshold flips. The run is held
  to parity on every frame before the first status difference, to inlier
  counts within EDGE_INLIERS of each other on every tracked frame, and a
  status may differ only where both counts lie within EDGE_INLIERS of the
  threshold.

The JAX runs share one Frontend and local-BA program, compiled once: the
threshold is read on the host (ssvio_tpu/system.py::run_step), not traced.
"""

import dataclasses

import numpy as np
import pytest

from ssvio_tpu.eval import ate
from ssvio_tpu.system import System as SystemJ
from ssvio_tpu_torch import frontend as fe_t
from ssvio_tpu_torch.system import System as SystemT
from test_engine_chunked import _settings
from test_torch_engine import render_sequence
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

FLAVOURS = ("sw", "ymm", "pkmm", "mm", "mm_f32")

POS_ATOL_M = 5e-2        # tests/test_engine_chunked.py's tolerance
MAX_FRAMES = 12
TRACKING_GOOD = 62       # see module docstring
DEFAULT_GOOD = 50        # Settings().tracking_good
EDGE_INLIERS = 3


@pytest.fixture(scope="module")
def seq():
    return render_sequence()


def run_pair(seq, tracking_good, jax_programs=None):
    """The JAX and the port's System on "mm" at `tracking_good`, frame by
    frame in lockstep (module docstring). jax_programs: a JAX System whose
    Frontend and local-BA program to reuse. Returns {"jax": ..., "torch":
    ...} with the System, statuses, keyframe counts and inlier counts (None
    on frames that track nothing) per frame."""
    s_t, poses, L, R = seq
    s_j = _settings()
    s_j.lk_backend, s_j.lk_kernel = "pallas_interpret", "mm"
    s_t = dataclasses.replace(s_t, lk_backend="ref", lk_kernel="mm")
    s_j.tracking_good = s_t.tracking_good = tracking_good
    sys_j = SystemJ(s_j, enable_backend=True, enable_loop_closing=False)
    if jax_programs is not None:
        sys_j.frontend = jax_programs.frontend
        sys_j._local_ba = jax_programs._local_ba
    sys_t = SystemT(s_t, enable_backend=True, enable_loop_closing=False,
                    device="cpu")
    out = {tag: dict(sys=sys_, status=[], kf=[], inliers=[])
           for tag, sys_ in (("jax", sys_j), ("torch", sys_t))}
    for i in range(MAX_FRAMES):
        for rec in out.values():
            sys_ = rec["sys"]
            tracked = sys_.status in (fe_t.TRACKING_GOOD, fe_t.TRACKING_BAD)
            sys_.run_step(L[i], R[i], 0.1 * i)
            rec["status"].append(sys_.status)
            rec["kf"].append(sys_.stats["n_keyframes"])
            rec["inliers"].append(sys_._health_window[-1] if tracked
                                  else None)
        last = [rec["status"][-1] for rec in out.values()]
        # stop after the first steady keyframe (a TRACKING_BAD frame) or
        # at the first status difference
        if i > 0 and (fe_t.TRACKING_BAD in last or last[0] != last[1]):
            break
    return out


@pytest.fixture(scope="module")
def runs(seq):
    raised = run_pair(seq, TRACKING_GOOD)
    return dict(raised, gt=seq[1],
                default=run_pair(seq, DEFAULT_GOOD, raised["jax"]["sys"]))


def test_mm_slice_statuses_and_keyframes_match(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["status"] == j["status"]
    assert t["kf"] == j["kf"]
    assert t["status"][0] == fe_t.TRACKING_GOOD
    assert t["status"][-1] == fe_t.TRACKING_BAD      # a steady keyframe
    assert fe_t.LOST not in t["status"]
    assert [k["frame_id"] for k in t["sys"].records.keyframes] == \
        [k["frame_id"] for k in j["sys"].keyframes]


def test_mm_slice_trajectory_matches(runs):
    j, t = runs["jax"], runs["torch"]
    _, tj = j["sys"].frame_trajectory()
    _, tt = t["sys"].frame_trajectory()
    assert len(tt) == len(tj) == len(t["status"])
    np.testing.assert_allclose(tt[:, :, 3], tj[:, :, 3], atol=POS_ATOL_M)
    for est in (tt, tj):
        assert ate.ape_translation(
            est[:, :, 3], runs["gt"][:len(est), :, 3])["rmse"] < 0.3


def test_mm_slice_at_the_default_threshold(runs):
    """At tracking_good = 50 (module docstring): parity on every frame
    before the first status difference, inlier counts within EDGE_INLIERS
    of each other on every tracked frame, and a status differs only on the
    last frame run, where both counts lie within EDGE_INLIERS of 50."""
    j, t = runs["default"]["jax"], runs["default"]["torch"]
    n = len(t["status"])
    assert len(j["status"]) == n
    inl = list(zip(t["inliers"], j["inliers"]))
    assert all((a is None) == (b is None) for a, b in inl), inl
    assert all(abs(a - b) <= EDGE_INLIERS for a, b in inl if a is not None), \
        inl
    differ = [i for i in range(n) if t["status"][i] != j["status"][i]]
    k = differ[0] if differ else n
    assert differ in ([], [n - 1]), (t["status"], j["status"])
    if differ:
        assert all(abs(c - DEFAULT_GOOD) <= EDGE_INLIERS for c in inl[k]), inl
    assert k >= 5, (k, inl)
    assert t["kf"][:k] == j["kf"][:k]
    assert fe_t.LOST not in t["status"]
    _, tj = j["sys"].frame_trajectory()
    _, tt = t["sys"].frame_trajectory()
    np.testing.assert_allclose(tt[:k, :, 3], tj[:k, :, 3], atol=POS_ATOL_M)


@pytest.mark.parametrize("kernel", FLAVOURS)
def test_every_flavour_builds_and_runs_a_system(seq, kernel):
    """Settings(lk_kernel=k) builds a System and runs the first frames
    (init, then tracking) on the flavour's plain version; an unknown
    flavour raises when the System is built."""
    s, poses, L, R = seq
    s = dataclasses.replace(s, lk_backend="ref", lk_kernel=kernel)
    sys_ = SystemT(s, enable_backend=True, enable_loop_closing=False,
                   device="cpu")
    assert sys_.frontend.lk_params.kernel == kernel
    for i in range(3):
        sys_.run_step(L[i], R[i], 0.1 * i)
        assert sys_.status == fe_t.TRACKING_GOOD
    _, est = sys_.frame_trajectory()
    assert np.all(np.isfinite(est))
    assert ate.ape_translation(est[:, :, 3], poses[:3, :, 3])["rmse"] < 0.1
    with pytest.raises(ValueError, match="LK kernel 'roll'"):
        SystemT(dataclasses.replace(s, lk_kernel="roll"), device="cpu")
